// N-Quad scanner: the native hot loop of bulk ingest (copy of
// dgraph_tpu/native/nquad_scan.cpp).
//
// Tokenizes a UTF-8 buffer of N-Quad statements (same grammar as
// dgraph_tpu_torch/rdf/parse.py, which mirrors Dgraph's rdf/parse.go)
// into struct-of-arrays output, interning subjects / predicates /
// uid-object refs / language tags / type names into unique span tables so
// the Python side resolves each distinct string exactly once and applies
// edges in vectorized per-predicate groups.
//
// The reference's loader parses each line with a Go lexer on the client
// (cmd/dgraphloader/main.go:151 → rdf.Parse); here parsing happens
// server-side in one pass over the mutation body.  No allocation per
// quad: all output is preallocated arrays handed in by the caller.
//
// Built by dgraph_tpu_torch/ops/_build.py (g++ -O2 -std=c++17 -shared
// -fPIC) into dgraph_tpu_torch/_build/ at first use.
// ABI: plain C, ctypes-friendly.

#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct SpanTable {
    // interned spans: (start, end) into the input buffer
    std::vector<int32_t> starts;
    std::vector<int32_t> ends;
    std::unordered_map<std::string_view, int32_t> index;

    int32_t intern(const char* buf, int32_t s, int32_t e) {
        std::string_view key(buf + s, static_cast<size_t>(e - s));
        auto it = index.find(key);
        if (it != index.end()) return it->second;
        int32_t id = static_cast<int32_t>(starts.size());
        starts.push_back(s);
        ends.push_back(e);
        index.emplace(key, id);
        return id;
    }
};

// exactly Python's \s (re module, ASCII range): [ \t\n\r\f\v] — and is_sp
// is [^\S\n] (horizontal whitespace).  Width parity with the Python
// grammar matters: acceptance must not depend on whether g++ was present.
inline bool is_ws(char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\f' || c == '\v';
}
inline bool is_sp(char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\f' || c == '\v';
}

inline bool is_blank_char(char c) {
    return (c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z') ||
           (c >= '0' && c <= '9') || c == '.' || c == '_' || c == '-';
}
inline bool is_pred_start(char c) {
    return (c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z') || c == '_';
}
inline bool is_pred_char(char c) {
    return is_pred_start(c) || (c >= '0' && c <= '9') || c == '.' || c == '-';
}
inline bool is_lang_char(char c) {
    return (c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z') || c == '-' || c == ':';
}

// parse "<0x1f>" span (excl. angles) as a hex uid; -1 if not that shape
int64_t hex_uid(const char* buf, int32_t s, int32_t e) {
    if (e - s < 3) return -1;
    if (buf[s] != '0' || (buf[s + 1] != 'x' && buf[s + 1] != 'X')) return -1;
    int64_t v = 0;
    for (int32_t i = s + 2; i < e; ++i) {
        char c = buf[i];
        int d;
        if (c >= '0' && c <= '9') d = c - '0';
        else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
        else if (c >= 'A' && c <= 'F') d = c - 'A' + 10;
        else return -1;
        if (v > (INT64_MAX >> 4)) return -1;  // overflow guard
        v = (v << 4) | d;
    }
    return v;
}

}  // namespace

// flags bits (keep in sync with dgraph_tpu_torch/native/__init__.py)
enum : uint16_t {
    F_OBJ_LITERAL = 1 << 0,
    F_HAS_LANG = 1 << 1,
    F_HAS_TYPE = 1 << 2,
    F_HAS_FACETS = 1 << 3,
    F_SUBJ_STAR = 1 << 4,
    F_PRED_STAR = 1 << 5,
    F_OBJ_STAR = 1 << 6,
    F_LIT_ESCAPED = 1 << 7,
    F_HAS_LABEL = 1 << 8,
};

extern "C" {

// Scan `buf[0:len)`.  Returns the number of quads parsed, or -(offset+1)
// of the first byte of an unparseable statement.
//
// Per-quad outputs (caller allocates to max_quads):
//   subj_idx / pred_idx : index into the respective unique tables
//   obj_idx             : index into the object-ref table, or -1 (literal/star)
//   lang_idx, type_idx  : index into lang/type tables, or -1
//   lit_s / lit_e       : literal body span (inside the quotes), else -1
//   facet_s / facet_e   : facet body span (inside parens), else -1
//   flags               : F_* bits above
//
// Unique tables (caller allocates to max_quads entries; counts returned
// via n_*): subj / pred / objref / lang / type span starts+ends, plus
// subj_uid / objref_uid: the hex uid for <0x..> spans, else -1.
long nq_scan(const char* buf, long len, long max_quads,
             int32_t* subj_idx, int32_t* pred_idx, int32_t* obj_idx,
             int32_t* lang_idx, int32_t* type_idx,
             int32_t* lit_s, int32_t* lit_e,
             int32_t* facet_s, int32_t* facet_e,
             uint16_t* flags,
             int32_t* u_subj_s, int32_t* u_subj_e, int64_t* u_subj_uid, long* n_subj,
             int32_t* u_pred_s, int32_t* u_pred_e, long* n_pred,
             int32_t* u_obj_s, int32_t* u_obj_e, int64_t* u_obj_uid, long* n_obj,
             int32_t* u_lang_s, int32_t* u_lang_e, long* n_lang,
             int32_t* u_type_s, int32_t* u_type_e, long* n_type) {
    SpanTable subjects, preds, objrefs, langs, types;
    long n = 0;
    long pos = 0;

    auto skip_ws_comments = [&]() {
        for (;;) {
            while (pos < len && is_ws(buf[pos])) ++pos;
            if (pos < len && buf[pos] == '#') {
                while (pos < len && buf[pos] != '\n') ++pos;
                continue;
            }
            return;
        }
    };

    // term kinds for subject/object position
    enum Kind { K_IRI, K_BLANK, K_STAR, K_LITERAL, K_BAD };

    // scan an IRI/blank/star term; returns kind, sets [s,e) to the span
    // (for IRIs: inside the angle brackets)
    auto scan_ref = [&](int32_t& s, int32_t& e) -> Kind {
        if (pos >= len) return K_BAD;
        char c = buf[pos];
        if (c == '<') {
            s = static_cast<int32_t>(++pos);
            while (pos < len && buf[pos] != '>' && buf[pos] != '\n') ++pos;
            if (pos >= len || buf[pos] != '>') return K_BAD;
            e = static_cast<int32_t>(pos);
            ++pos;
            return K_IRI;
        }
        if (c == '_' && pos + 1 < len && buf[pos + 1] == ':') {
            s = static_cast<int32_t>(pos);
            pos += 2;
            while (pos < len && is_blank_char(buf[pos])) ++pos;
            e = static_cast<int32_t>(pos);
            if (e - s <= 2) return K_BAD;
            return K_BLANK;
        }
        if (c == '*') {
            s = static_cast<int32_t>(pos);
            e = static_cast<int32_t>(++pos);
            return K_STAR;
        }
        return K_BAD;
    };

    while (true) {
        skip_ws_comments();
        if (pos >= len) break;
        if (n >= max_quads) return -(pos + 1);
        long stmt_start = pos;
        uint16_t fl = 0;

        // ---- subject --------------------------------------------------
        int32_t ss = -1, se = -1;
        Kind sk = scan_ref(ss, se);
        if (sk == K_BAD || sk == K_LITERAL) return -(stmt_start + 1);
        if (sk == K_STAR) fl |= F_SUBJ_STAR;
        // the Python grammar requires \s+ between terms (_QUAD_RE): zero
        // whitespace must error here so both paths reject identically
        if (pos < len && !is_ws(buf[pos])) return -(stmt_start + 1);
        while (pos < len && is_ws(buf[pos])) ++pos;

        // ---- predicate ------------------------------------------------
        int32_t ps = -1, pe = -1;
        if (pos < len && buf[pos] == '<') {
            int32_t dummy_s, dummy_e;
            if (scan_ref(dummy_s, dummy_e) != K_IRI) return -(stmt_start + 1);
            ps = dummy_s; pe = dummy_e;
        } else if (pos < len && buf[pos] == '*') {
            ps = static_cast<int32_t>(pos); pe = static_cast<int32_t>(++pos);
            fl |= F_PRED_STAR;
        } else {
            // predicates are IRIREF (or *) only — the reference lexer
            // rejects bare names ("The predicate can only be an IRI",
            // rdf/state.go:249); bare-pred acceptance would let typo'd
            // quads silently create new predicates
            return -(stmt_start + 1);
        }
        if (pos < len && !is_ws(buf[pos])) return -(stmt_start + 1);  // \s+ again
        while (pos < len && is_ws(buf[pos])) ++pos;

        // ---- object ---------------------------------------------------
        int32_t os = -1, oe = -1;
        int32_t l_s = -1, l_e = -1, la_s = -1, la_e = -1, ty_s = -1, ty_e = -1;
        Kind ok_ = K_BAD;
        if (pos < len && buf[pos] == '"') {
            fl |= F_OBJ_LITERAL;
            ok_ = K_LITERAL;
            l_s = static_cast<int32_t>(++pos);
            while (pos < len && buf[pos] != '"') {
                if (buf[pos] == '\\' && pos + 1 < len) {
                    // backslash-newline is NOT a valid escape in the
                    // Python grammar ('\\.' never matches \n) — reject so
                    // both paths 400 identically
                    if (buf[pos + 1] == '\n') return -(stmt_start + 1);
                    fl |= F_LIT_ESCAPED;
                    pos += 2;
                } else {
                    ++pos;  // raw newlines inside literals are allowed
                }
            }
            if (pos >= len) return -(stmt_start + 1);
            l_e = static_cast<int32_t>(pos);
            ++pos;  // closing quote
            if (pos < len && buf[pos] == '@') {
                fl |= F_HAS_LANG;
                la_s = static_cast<int32_t>(++pos);
                while (pos < len && is_lang_char(buf[pos])) ++pos;
                la_e = static_cast<int32_t>(pos);
                if (la_e == la_s) return -(stmt_start + 1);
            } else if (pos + 1 < len && buf[pos] == '^' && buf[pos + 1] == '^') {
                pos += 2;
                if (pos >= len || buf[pos] != '<') return -(stmt_start + 1);
                fl |= F_HAS_TYPE;
                ty_s = static_cast<int32_t>(++pos);
                while (pos < len && buf[pos] != '>' && buf[pos] != '\n') ++pos;
                if (pos >= len || buf[pos] != '>') return -(stmt_start + 1);
                ty_e = static_cast<int32_t>(pos);
                ++pos;
            }
        } else {
            ok_ = scan_ref(os, oe);
            if (ok_ == K_BAD) return -(stmt_start + 1);
            if (ok_ == K_STAR) fl |= F_OBJ_STAR;
        }
        long sp0 = pos;
        while (pos < len && is_sp(buf[pos])) ++pos;

        // ---- optional label <g> (needs [^\S\n]+ before it) -----------
        if (pos < len && buf[pos] == '<') {
            if (pos == sp0) return -(stmt_start + 1);
            int32_t gs, ge;
            if (scan_ref(gs, ge) != K_IRI) return -(stmt_start + 1);
            fl |= F_HAS_LABEL;
            while (pos < len && is_ws(buf[pos])) ++pos;
        }

        // ---- optional facets ( ... ) ---------------------------------
        int32_t f_s = -1, f_e = -1;
        while (pos < len && is_ws(buf[pos])) ++pos;
        if (pos < len && buf[pos] == '(') {
            fl |= F_HAS_FACETS;
            f_s = static_cast<int32_t>(++pos);
            while (pos < len && buf[pos] != ')') ++pos;
            if (pos >= len) return -(stmt_start + 1);
            f_e = static_cast<int32_t>(pos);
            ++pos;
        }

        // ---- terminator ----------------------------------------------
        while (pos < len && is_ws(buf[pos])) ++pos;
        if (pos >= len || buf[pos] != '.') return -(stmt_start + 1);
        ++pos;
        while (pos < len && is_sp(buf[pos])) ++pos;
        // trailing comment after the dot
        if (pos < len && buf[pos] == '#') {
            while (pos < len && buf[pos] != '\n') ++pos;
        }

        // ---- emit -----------------------------------------------------
        subj_idx[n] = (sk == K_STAR) ? -1 : subjects.intern(buf, ss, se);
        pred_idx[n] = (fl & F_PRED_STAR) ? -1 : preds.intern(buf, ps, pe);
        obj_idx[n] = (ok_ == K_IRI || ok_ == K_BLANK) ? objrefs.intern(buf, os, oe) : -1;
        lang_idx[n] = (fl & F_HAS_LANG) ? langs.intern(buf, la_s, la_e) : -1;
        type_idx[n] = (fl & F_HAS_TYPE) ? types.intern(buf, ty_s, ty_e) : -1;
        lit_s[n] = l_s; lit_e[n] = l_e;
        facet_s[n] = f_s; facet_e[n] = f_e;
        flags[n] = fl;
        ++n;
    }

    // ---- unique tables out -------------------------------------------
    auto dump = [&](SpanTable& t, int32_t* s_out, int32_t* e_out, int64_t* uid_out) {
        for (size_t i = 0; i < t.starts.size(); ++i) {
            s_out[i] = t.starts[i];
            e_out[i] = t.ends[i];
            if (uid_out) {
                // blank nodes ("_:x") are never hex uids; IRIs may be <0x..>
                uid_out[i] = (buf[t.starts[i]] == '_')
                                 ? -1
                                 : hex_uid(buf, t.starts[i], t.ends[i]);
            }
        }
        return static_cast<long>(t.starts.size());
    };
    *n_subj = dump(subjects, u_subj_s, u_subj_e, u_subj_uid);
    *n_pred = dump(preds, u_pred_s, u_pred_e, nullptr);
    *n_obj = dump(objrefs, u_obj_s, u_obj_e, u_obj_uid);
    *n_lang = dump(langs, u_lang_s, u_lang_e, nullptr);
    *n_type = dump(types, u_type_s, u_type_e, nullptr);
    return n;
}

}  // extern "C"
