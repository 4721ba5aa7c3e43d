"""Compact Snowball-style stemmers for the fulltext tokenizer.

The reference delegates to bleve's per-language snowball stemmers
(tok/fts.go:46-142: one analyzer per language — tokenize, lowercase,
language stopwords, language stemmer).  We implement light versions of
the Snowball algorithms for the documented language set below; what
matters for retrieval correctness is that index build and query apply
the SAME reduction, and that regular inflections within a language
actually conflate (Lieder/Liedern → lied).  Unknown languages fall back
to identity (tokens still match exactly).

Supported: en (Porter), de, fr, es.  Inputs arrive lowercased and
diacritic-stripped by tok._normalize, so the German umlaut / French
accent handling of full Snowball is subsumed by normalization.
"""

from __future__ import annotations

_VOWELS = set("aeiou")


def _measure(s: str) -> int:
    """Porter's m: number of VC sequences."""
    m, prev_v = 0, False
    for i, c in enumerate(s):
        v = c in _VOWELS or (c == "y" and i > 0 and s[i - 1] not in _VOWELS)
        if prev_v and not v:
            m += 1
        prev_v = v
    return m


def _has_vowel(s: str) -> bool:
    return any(c in _VOWELS or (c == "y" and i > 0) for i, c in enumerate(s))


def _r1(w: str, vowels: str, minpos: int = 0) -> int:
    """Snowball R1: position after the first non-vowel that follows a
    vowel (len(w) if none); clamped to ``minpos`` (German uses 3)."""
    for i in range(1, len(w)):
        if w[i] not in vowels and w[i - 1] in vowels:
            return max(i + 1, minpos)
    return len(w)


def _stem_de(w: str) -> str:
    """Light Snowball German (snowball/german): three suffix steps
    gated on R1/R2.  Umlauts are already stripped by normalization."""
    V = "aeiouy"
    w = w.replace("ß", "ss")
    r1 = _r1(w, V, 3)
    r2 = len(w[:r1]) + _r1(w[r1:], V) if r1 < len(w) else len(w)
    # step 1
    for suf in ("ern", "em", "er"):
        if w.endswith(suf) and len(w) - len(suf) >= r1:
            w = w[: -len(suf)]
            break
    else:
        for suf in ("en", "es", "e"):
            if w.endswith(suf) and len(w) - len(suf) >= r1:
                w = w[: -len(suf)]
                break
        else:
            if w.endswith("s") and len(w) - 1 >= r1 and len(w) >= 2 and w[-2] in "bdfghklmnrt":
                w = w[:-1]
    # step 2
    for suf in ("est", "er", "en"):
        if w.endswith(suf) and len(w) - len(suf) >= r1:
            w = w[: -len(suf)]
            break
    else:
        if w.endswith("st") and len(w) - 2 >= r1 and len(w) > 5 and w[-3] in "bdfghklmnt":
            w = w[:-2]
    # step 3 (derivational, R2)
    for suf in ("isch", "lich", "heit", "keit", "end", "ung", "ig", "ik"):
        if w.endswith(suf) and len(w) - len(suf) >= r2:
            if suf in ("isch", "ig", "ik") and len(w) > len(suf) and w[-len(suf) - 1] == "e":
                break  # not preceded by e
            w = w[: -len(suf)]
            break
    return w


def _stem_fr(w: str) -> str:
    """Light Snowball French: strip derivational suffixes in R1/R2, then
    residual verb/plural endings.  Accents already stripped upstream."""
    V = "aeiouy"
    # plural -aux forms conflate with the singular (cheval/chevaux,
    # national/nationaux) before region computation
    if w.endswith("eaux"):
        w = w[:-1]
    elif w.endswith("aux") and len(w) > 4:
        w = w[:-2] + "l"
    r1 = _r1(w, V)
    r2 = len(w[:r1]) + _r1(w[r1:], V) if r1 < len(w) else len(w)
    for suf, minr in (
        ("issements", r1), ("issement", r1), ("atrices", r2), ("atrice", r2),
        ("ateurs", r2), ("ations", r2), ("logies", r2), ("usions", r2),
        ("ution", r2), ("ateur", r2), ("ation", r2), ("logie", r2),
        ("ments", r1), ("ment", r1), ("ances", r2), ("iques", r2),
        ("ismes", r2), ("ables", r2), ("istes", r2), ("ance", r2),
        ("ique", r2), ("isme", r2), ("able", r2), ("iste", r2),
        ("eux", r1), ("euses", r1), ("euse", r1), ("ites", r2), ("ite", r2),
    ):
        if w.endswith(suf) and len(w) - len(suf) >= minr:
            w = w[: -len(suf)]
            break
    else:
        # verb endings (RV approximated by R1).  No bare "-ons"/"-et":
        # they would split noun plurals (chansons/chanson) — a light
        # stemmer prioritizes noun/adjective consistency over first-person
        # plural verb conflation.
        for suf in (
            "eraient", "assent", "erions", "eront", "erais", "erait",
            "antes", "aient", "erent", "erons", "asse", "ante", "ants", "ait",
            "ant", "ees", "era", "iez", "ent", "ais", "ee", "er",
            "es", "ez", "e",
        ):
            if w.endswith(suf) and len(w) - len(suf) >= max(r1, 2):
                w = w[: -len(suf)]
                break
        else:
            if w.endswith("s") and len(w) - 1 >= 2:
                w = w[:-1]
    return w


def _stem_es(w: str) -> str:
    """Light Snowball Spanish: derivational suffixes in R2, then verb
    endings, then residual vowel."""
    V = "aeiouy"
    r1 = _r1(w, V)
    r2 = len(w[:r1]) + _r1(w[r1:], V) if r1 < len(w) else len(w)
    for suf in (
        "amientos", "imientos", "amiento", "imiento", "aciones", "adoras",
        "adores", "idades", "acion", "adora", "antes", "ancia", "ibles",
        "istas", "ables", "mente", "ador", "ante", "idad", "able", "ible",
        "ista", "osos", "osas", "ivas", "ivos", "oso", "osa", "iva", "ivo",
    ):
        if w.endswith(suf) and len(w) - len(suf) >= r2:
            w = w[: -len(suf)]
            break
    # verb endings CASCADE after derivational strip so e.g. rapidamente →
    # rapida → rap reduces identically to the bare adjective rapida
    for suf in (
        "aremos", "eremos", "iremos", "asteis", "isteis", "ariamos",
        "aciones", "ierais", "aramos", "ieron", "iendo", "ando", "aban",
        "aran", "aria", "arian", "abas", "adas", "idas", "ados", "idos",
        "amos", "emos", "imos", "aste", "iste", "aba", "ada", "ida",
        "ado", "ido", "ian", "ara", "are", "ais", "eis", "an", "ar",
        "er", "ir", "as", "es", "ia", "io",
    ):
        if w.endswith(suf) and len(w) - len(suf) >= max(r1, 2):
            w = w[: -len(suf)]
            break
    else:
        # residual final vowel (snowball's step 3)
        if w and w[-1] in "aeo" and len(w) - 1 >= max(r1, 2):
            w = w[:-1]
    return w


def _stem_it(w: str) -> str:
    """Light Snowball Italian: derivational suffixes in R2, verb endings
    (RV approximated by R1), then the residual final vowel."""
    V = "aeiouy"
    r1 = _r1(w, V)
    r2 = len(w[:r1]) + _r1(w[r1:], V) if r1 < len(w) else len(w)
    for suf in (
        "amenti", "imenti", "amento", "imento", "azioni", "azione",
        "atrici", "atrice", "logie", "logia", "mente", "ibili", "abili",
        "ibile", "abile", "anze", "anza", "iche", "ichi", "ismi", "ismo",
        "iste", "isti", "ista", "ose", "osi", "osa", "oso", "ive", "ivi",
        "iva", "ivo", "ico", "ica", "ici",
    ):
        if w.endswith(suf) and len(w) - len(suf) >= r2:
            w = w[: -len(suf)]
            break
    for suf in (
        "erebbero", "irebbero", "assero", "essero", "issero", "eranno",
        "iranno", "iscono", "iscano", "avamo", "evamo", "ivamo", "avano",
        "evano", "ivano", "assi", "ando", "endo", "iamo", "ano", "ono",
        "ato", "ata", "ati", "ate", "ito", "ita", "iti", "ite", "ava",
        "eva", "iva", "are", "ere", "ire", "era", "ira",
    ):
        if w.endswith(suf) and len(w) - len(suf) >= max(r1, 2):
            w = w[: -len(suf)]
            break
    else:
        # residual final vowel (canzoni/canzone → canzon)
        if w and w[-1] in "aeio" and len(w) - 1 >= max(r1, 2):
            w = w[:-1]
            if w and w[-1] == "i" and len(w) - 1 >= max(r1, 2):
                w = w[:-1]
    return w


def _stem_pt(w: str) -> str:
    """Light Snowball Portuguese: derivational suffixes in R2, verb
    endings, residual vowel.  Accents/cedilla stripped upstream, so
    -ção arrives as -cao."""
    V = "aeiouy"
    # irregular plural classes conflate with the singular BEFORE region
    # computation (canções/canção → cancao, animais/animal → animal)
    if w.endswith("oes") and len(w) > 4:
        w = w[:-3] + "ao"
    elif w.endswith("ais") and len(w) > 4:
        w = w[:-2] + "l"
    elif w.endswith("eis") and len(w) > 4:
        w = w[:-2] + "l"
    r1 = _r1(w, V)
    r2 = len(w[:r1]) + _r1(w[r1:], V) if r1 < len(w) else len(w)
    for suf in (
        "amentos", "imentos", "amento", "imento", "adoras", "adores",
        "idades", "logias", "logia", "mente", "acoes", "adora", "istas",
        "iveis", "ancia", "ivel", "avel", "ador", "idade", "ista", "icos",
        "icas", "osos", "osas", "ivos", "ivas", "acao", "ico", "ica",
        "oso", "osa", "ivo", "iva", "eza", "ezas",
    ):
        if w.endswith(suf) and len(w) - len(suf) >= r2:
            w = w[: -len(suf)]
            break
    for suf in (
        "ariamos", "eriamos", "iriamos", "assemos", "essemos", "issemos",
        "aremos", "eremos", "iremos", "avamos", "aramos", "eramos",
        "iramos", "iamos", "aram", "eram", "iram", "avam", "ando", "endo",
        "indo", "ados", "idos", "adas", "idas", "amos", "emos", "imos",
        "aste", "este", "iste", "aria", "eria", "iria", "asse", "esse",
        "isse", "ava", "ado", "ido", "ada", "ida", "ara", "era", "ira",
        "iam", "am", "em", "ar", "er", "ir", "eu", "iu", "ou", "ia",
    ):
        if w.endswith(suf) and len(w) - len(suf) >= max(r1, 2):
            w = w[: -len(suf)]
            break
    else:
        if w.endswith("s") and len(w) - 1 >= 2:
            w = w[:-1]
        if w and w[-1] in "aeo" and len(w) - 1 >= max(r1, 2):
            w = w[:-1]
    return w


def _stem_nl(w: str) -> str:
    """Light Snowball Dutch: plural/inflection endings gated on R1 with
    consonant undoubling, then derivational suffixes in R2 (the German
    cousin — snowball/dutch)."""
    V = "aeiouy"
    r1 = _r1(w, V, 3)
    r2 = len(w[:r1]) + _r1(w[r1:], V) if r1 < len(w) else len(w)

    def undouble(s: str) -> str:
        if len(s) >= 2 and s[-1] == s[-2] and s[-1] in "bdfgklmnprst":
            return s[:-1]
        return s

    if w.endswith("heden") and len(w) - 5 >= r1:
        w = w[:-5] + "heid"
    elif w.endswith("ene") and len(w) - 3 >= r1 and (len(w) < 4 or w[-4] not in V):
        w = undouble(w[:-3])
    elif w.endswith("en") and len(w) - 2 >= r1 and (len(w) < 3 or w[-3] not in V):
        w = undouble(w[:-2])
    elif w.endswith("se") and len(w) - 2 >= r1:
        w = w[:-2]
    elif w.endswith("s") and len(w) - 1 >= r1 and len(w) >= 2 and w[-2] not in V + "j":
        w = w[:-1]
    # e-deletion (step 2)
    if w.endswith("e") and len(w) - 1 >= r1 and len(w) >= 2 and w[-2] not in V:
        w = undouble(w[:-1])
    # derivational (step 3)
    if w.endswith("heid") and len(w) - 4 >= r2:
        w = w[:-4]
    for suf in ("lijk", "baar", "end", "ing", "bar", "ig"):
        if w.endswith(suf) and len(w) - len(suf) >= r2:
            if suf in ("ig", "ing", "end") and len(w) > len(suf) and w[-len(suf) - 1] == "e":
                break
            w = undouble(w[: -len(suf)])
            break
    return w


_RU_V = "аеиоуыэюяё"


def _ru_fold(sufs):
    """tok._normalize folds й→и (NFKD strips the combining breve), so
    suffix lists must live in the FOLDED alphabet or they never match.
    Applied ONCE at module load — not per word."""
    return tuple(s.replace("й", "и") for s in sufs)


_RU_ADJECTIVAL = _ru_fold((
    "ейшими", "ейшего", "ейшему", "ейшая", "ейшее", "ейших", "ейший",
    "ующими", "ившись", "ывшись", "авшись",
    "ующая", "ующее", "ующий", "ующих",
    "иями", "ями", "ами", "ыми", "ими", "его", "ого", "ему", "ому",
    "ее", "ие", "ые", "ое", "ей", "ий", "ый", "ой", "ем", "им", "ым",
    "ом", "их", "ых", "ую", "юю", "ая", "яя", "ою", "ею",
))
_RU_VERBAL = _ru_fold((
    "уйте", "ейте", "ила", "ыла", "ена", "ите", "или", "ыли",
    "ило", "ыло", "ено", "ует", "уют", "ить", "ыть", "ишь", "ете",
    "йте", "ены", "нно", "ешь", "ть", "ет", "ют", "ны", "ло",
    "но", "ла", "на", "ли", "ем", "ил", "ыл", "им", "ым", "ен",
    "ят", "ит", "ыт", "уй", "ей", "ую", "й", "л", "н", "ю",
))
_RU_NOUN = _ru_fold((
    "иями", "иях", "ией", "иям", "ием", "ями", "ами", "ях", "ам",
    "ем", "ей", "ём", "ой", "ий", "ию", "ью", "ия", "ья", "ев",
    "ов", "ие", "ье", "еи", "ии", "и", "ы", "ь", "ю", "я", "а",
    "е", "о", "у", "й",
))


def _stem_ru(w: str) -> str:
    """Light Snowball Russian over Cyrillic (tok._normalize lowercases
    and folds й→и via NFKD, symmetrically at index and query time).
    Suffix classes in Snowball's order — adjectival, verbal, noun — each
    gated on R1, then the residual -и/-ь/-нн cleanups."""
    r1 = _r1(w, _RU_V)

    def strip_class(word, sufs):
        for suf in sufs:
            if word.endswith(suf) and len(word) - len(suf) >= max(r1, 2):
                return word[: -len(suf)], True
        return word, False

    w, hit = strip_class(w, _RU_ADJECTIVAL)
    if not hit:
        w, hit = strip_class(w, _RU_VERBAL)
    if not hit:
        w, _ = strip_class(w, _RU_NOUN)
    for suf in ("ость", "ост"):
        if w.endswith(suf) and len(w) - len(suf) >= max(r1, 2):
            w = w[: -len(suf)]
            break
    if w.endswith("и") and len(w) - 1 >= max(r1, 2):
        w = w[:-1]
    if w.endswith("нн") and len(w) - 1 >= max(r1, 2):
        w = w[:-1]
    if w.endswith("ь") and len(w) - 1 >= max(r1, 2):
        w = w[:-1]
    return w


def _scand_stemmer(extra_sufs):
    """Shared light Snowball for the Scandinavian trio: one suffix pass
    in R1 (min 3), then the residual -s after a valid consonant.
    ø and æ have no NFKD decomposition (unlike å/ä/ö, which fold to
    a/a/o upstream), so they stay distinct letters and must count as
    vowels here."""
    def f(w: str) -> str:
        V = "aeiouyøæ"
        r1 = _r1(w, V, 3)
        for suf in extra_sufs:
            if w.endswith(suf) and len(w) - len(suf) >= r1:
                w = w[: -len(suf)]
                return f2(w, r1)
        return f2(w, r1)

    def f2(w, r1):
        if (
            w.endswith("s")
            and len(w) - 1 >= r1
            and len(w) >= 2
            and w[-2] in "bcdfghjklmnoprtvyz"
        ):
            w = w[:-1]
        if w.endswith("ert") and len(w) - 3 >= r1:
            w = w[:-3]
        return w

    return f


_stem_sv = _scand_stemmer((
    "heterna", "hetens", "heten", "heter", "arnas", "ernas", "ornas",
    "andes", "andet", "arens", "arna", "erna", "orna", "ande", "arne",
    "aste", "aren", "ades", "erns", "ade", "are", "ern", "ens", "het",
    "ast", "ad", "en", "ar", "er", "or", "at", "a", "e",
))
_stem_da = _scand_stemmer((
    "erendes", "erende", "heders", "ethed", "erede", "heden", "heder",
    "endes", "ernes", "erens", "erets", "ered", "ende", "erne", "eren",
    "erer", "eret", "hed", "ene", "ere", "ens", "ers", "ets", "en",
    "er", "es", "et", "e",
))
_stem_no = _scand_stemmer((
    "hetenes", "hetens", "hetene", "endes", "heten", "heter", "edes",
    "enes", "ande", "ende", "edes", "ene", "ane", "ede", "ens", "ers",
    "ets", "het", "ast", "en", "ar", "er", "as", "es", "et", "a", "e",
))


def _stem_hu(w: str) -> str:
    """Light Hungarian: case suffixes, then the bare plural -k after a
    vowel, then the residual final a/e — cascaded, because Hungarian
    stacks case on plural (házakat → hazak → haza → haz).  Accented
    vowels are already folded to aeiou upstream."""
    V = "aeiou"
    r1 = _r1(w, V, 2)
    for suf in (
        "oknak", "eknek", "aknak", "okban", "ekben", "akban", "okat",
        "eket", "akat", "okba", "ekbe", "akba", "nak", "nek", "ban",
        "ben", "bol", "rol", "tol", "val", "vel", "hoz", "hez", "koz",
        "ra", "re", "ba", "be", "on", "en", "an", "ot", "et", "at",
    ):
        if w.endswith(suf) and len(w) - len(suf) >= max(r1, 2):
            w = w[: -len(suf)]
            break
    if (
        w.endswith("k")
        and len(w) >= 2
        and w[-2] in V
        and len(w) - 1 >= max(r1, 2)
    ):
        w = w[:-1]
    if w and w[-1] in "ae" and len(w) - 1 >= max(r1, 2):
        w = w[:-1]
    return w


def _stem_ro(w: str) -> str:
    """Light Romanian: definite articles + plural/verb endings in R1,
    then the residual final a/e/i (diacritics ă/â/î/ș/ț fold upstream)."""
    V = "aeiou"
    r1 = _r1(w, V, 2)
    for suf in (
        "urilor", "atiilor", "iilor", "elor", "ilor", "ului", "atii",
        "atie", "urile", "uri", "ule", "ele", "eau", "ind", "and",
        "are", "ere", "ire", "ate", "ute", "ite", "ii", "ul", "le",
        "ea", "ia", "ie", "iu",
    ):
        if w.endswith(suf) and len(w) - len(suf) >= max(r1, 2):
            w = w[: -len(suf)]
            break
    if w and w[-1] in "aei" and len(w) - 1 >= max(r1, 2):
        w = w[:-1]
    return w


def _stem_fi(w: str) -> str:
    """Light Finnish: the productive locative/partitive/genitive case
    endings and plural -t/-ja, cascaded once (ä/ö fold to a/o
    upstream, so talossa/taloissa both reduce over 'a-o' vowels)."""
    V = "aeiouy"
    r1 = _r1(w, V, 2)
    for suf in (
        "issa", "ista", "illa", "ilta", "ille", "iksi", "ssa", "sta",
        "lla", "lta", "lle", "ksi", "tta", "nsa", "ja", "an", "en",
        "in", "na", "ta",
    ):
        if w.endswith(suf) and len(w) - len(suf) >= max(r1, 2):
            if suf == "ja" and w[-3] not in V:
                continue  # partitive -ja follows a vowel (autoja, not kirja)
            w = w[: -len(suf)]
            break
    if (
        w.endswith("t")
        and len(w) >= 2
        and w[-2] in V
        and len(w) - 1 >= max(r1, 2)
    ):
        w = w[:-1]
    if w and w[-1] == "i" and len(w) - 1 >= max(r1, 2):
        w = w[:-1]
    return w


def _stem_tr(w: str) -> str:
    """Light Turkish: the agglutinated plural/possessive/case chain via
    ordered suffix strips (longest first), twice — Turkish stacks e.g.
    ev+ler+in+de.  Dotless ı survives NFKD and counts as a vowel; ş/ç/ğ
    fold to s/c/g upstream."""
    V = "aeiouı"  # ı
    r1 = _r1(w, V, 2)
    for _ in range(2):
        for suf in (
            "larinin", "lerinin", "larinda", "lerinde", "larindan",
            "lerinden", "larin", "lerin", "lari", "leri", "larda",
            "lerde", "lardan", "lerden", "lar", "ler", "nin",
            "nun", "dan", "den", "tan", "ten", "da", "de", "ta", "te",
            "in", "un", "si", "su",
        ):
            if w.endswith(suf) and len(w) - len(suf) >= max(r1, 2):
                w = w[: -len(suf)]
                break
        else:
            break
    # harmony variants with dotless ı (ları / ının / ında …)
    for suf in ("ları", "ının", "ında", "ından",
                "ın", "ı"):
        if w.endswith(suf) and len(w) - len(suf) >= max(r1, 2):
            w = w[: -len(suf)]
            break
    return w


_STEMMERS = {
    "de": _stem_de,
    "fr": _stem_fr,
    "es": _stem_es,
    "it": _stem_it,
    "pt": _stem_pt,
    "nl": _stem_nl,
    "ru": _stem_ru,
    "sv": _stem_sv,
    "da": _stem_da,
    "no": _stem_no,
    "nb": _stem_no,  # Bokmål tag maps to the Norwegian stemmer
    "hu": _stem_hu,
    "ro": _stem_ro,
    "fi": _stem_fi,
    "tr": _stem_tr,
}


def stem(word: str, lang: str = "en") -> str:
    if len(word) <= 2:
        return word
    if lang != "en":
        f = _STEMMERS.get(lang.split("-")[0] if lang else "")
        return f(word) if f else word
    w = word

    # step 1a: plurals
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]

    # step 1b: -ed / -ing
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        for suf in ("ed", "ing"):
            if w.endswith(suf) and _has_vowel(w[: -len(suf)]):
                w = w[: -len(suf)]
                if w.endswith(("at", "bl", "iz")):
                    w += "e"
                elif (
                    len(w) >= 2
                    and w[-1] == w[-2]
                    and w[-1] not in "lsz"
                    and w[-1] not in _VOWELS
                ):
                    w = w[:-1]
                elif _measure(w) == 1 and len(w) >= 3 and w[-1] not in _VOWELS and w[-2] in _VOWELS and w[-3] not in _VOWELS and w[-1] not in "wxy":
                    w += "e"
                break

    # step 1c: y -> i
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # step 2/3 (common suffix map, m>0)
    for suf, rep in (
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
        ("anci", "ance"), ("izer", "ize"), ("abli", "able"), ("alli", "al"),
        ("entli", "ent"), ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
        ("ation", "ate"), ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
        ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
        ("iviti", "ive"), ("biliti", "ble"), ("icate", "ic"), ("ative", ""),
        ("alize", "al"), ("iciti", "ic"), ("ical", "ic"), ("ful", ""),
        ("ness", ""),
    ):
        if w.endswith(suf):
            base = w[: -len(suf)]
            if _measure(base) > 0:
                w = base + rep
            break

    # step 4 (m>1 suffix deletion)
    for suf in (
        "ement", "ance", "ence", "able", "ible", "ant", "ent", "ism", "ate",
        "iti", "ous", "ive", "ize", "ment", "ion", "al", "er", "ic", "ou",
    ):
        if w.endswith(suf):
            base = w[: -len(suf)]
            if _measure(base) > 1:
                if suf == "ion" and base and base[-1] not in "st":
                    break
                w = base
            break

    # step 5
    if w.endswith("e"):
        if _measure(w[:-1]) > 1:
            w = w[:-1]
    if len(w) >= 2 and w[-1] == "l" and w[-2] == "l" and _measure(w) > 1:
        w = w[:-1]
    return w
