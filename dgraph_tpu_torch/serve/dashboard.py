"""Embedded query console served at `/` (the same page as
``dgraph_tpu/serve/dashboard.py``, byte for byte).

Equivalent of the reference's dashboard/ React app (query editor + D3
force-layout graph view, served at cmd/dgraph/main.go:652) re-done as a
single dependency-free HTML page: editor, JSON view, SVG force-layout
graph view, query history in localStorage, a schema browser, a live
server-stats panel (/debug/store + Prometheus counters), per-run latency
sparkline, and a debug toggle surfacing the engine's per-stage breakdown
(chain fusion, device/host ms, edges traversed).
"""

DASHBOARD_HTML = r"""<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>dgraph-tpu console</title>
<style>
  :root { --bg:#15181d; --panel:#1e2228; --fg:#d8dee6; --acc:#5b9dd9; --ok:#67b26f; }
  * { box-sizing: border-box; }
  body { margin:0; font:14px/1.45 system-ui,sans-serif; background:var(--bg); color:var(--fg);
         display:flex; flex-direction:column; height:100vh; }
  header { padding:10px 16px; background:var(--panel); display:flex; gap:12px; align-items:center; }
  header h1 { font-size:15px; margin:0; font-weight:600; }
  header .lat { margin-left:auto; color:#8a93a0; font-size:12px; }
  main { flex:1; display:flex; min-height:0; }
  .col { flex:1; display:flex; flex-direction:column; min-width:0; padding:10px; gap:8px; }
  textarea { flex:1; background:var(--panel); color:var(--fg); border:1px solid #2c323b;
             border-radius:6px; padding:10px; font:13px/1.4 ui-monospace,monospace; resize:none; }
  .btns { display:flex; gap:8px; }
  button { background:var(--acc); color:#fff; border:0; border-radius:6px; padding:7px 16px;
           font-size:13px; cursor:pointer; }
  button.alt { background:#343b45; }
  #out { flex:1; overflow:auto; background:var(--panel); border-radius:6px; padding:10px;
         font:12px/1.4 ui-monospace,monospace; white-space:pre; }
  #graph { flex:1; background:var(--panel); border-radius:6px; display:none; }
  #graph circle { fill:var(--acc); } #graph text { fill:var(--fg); font-size:10px; }
  #graph line { stroke:#4a5260; }
  #hist { font-size:12px; color:#8a93a0; max-height:72px; overflow:auto; }
  #hist div { cursor:pointer; padding:1px 0; } #hist div:hover { color:var(--fg); }
  #side { width:270px; background:var(--panel); border-left:1px solid #2c323b;
          padding:10px; overflow:auto; font-size:12px; }
  #side h2 { font-size:12px; margin:10px 0 4px; color:#8a93a0; text-transform:uppercase; }
  #side table { width:100%; border-collapse:collapse; }
  #side td { padding:1px 4px 1px 0; border-bottom:1px solid #262c34; }
  #spark { height:34px; width:100%; background:#181c22; border-radius:4px; }
  #spark rect { fill:var(--acc); }
  label.dbg { font-size:12px; color:#8a93a0; display:flex; gap:4px; align-items:center; }
  #engstats { color:#8a93a0; white-space:pre; font:11px/1.4 ui-monospace,monospace; }
</style>
</head>
<body>
<header><h1>dgraph-tpu</h1><span id="health">…</span><span class="lat" id="lat"></span></header>
<main>
  <div class="col">
    <textarea id="q" spellcheck="false">{
  everyone(func: has(name)) {
    name
  }
}</textarea>
    <div class="btns">
      <button onclick="run()">Run</button>
      <button class="alt" onclick="view('json')">JSON</button>
      <button class="alt" onclick="view('graph')">Graph</button>
      <button class="alt" onclick="share()">Share</button>
      <label class="dbg"><input type="checkbox" id="dbg"> debug</label>
    </div>
    <div id="hist"></div>
    <div id="engstats"></div>
  </div>
  <div class="col">
    <div id="out">// results</div>
    <svg id="graph"></svg>
  </div>
  <div id="side">
    <h2>latency</h2><svg id="spark"></svg>
    <h2>schema</h2><table id="schema"><tr><td>…</td></tr></table>
    <h2>server</h2><table id="stats"><tr><td>…</td></tr></table>
  </div>
</main>
<script>
const $ = id => document.getElementById(id);
fetch('/health').then(r=>r.text()).then(t=>$('health').textContent=t==='OK'?'● healthy':'○ down');
let last = null;
function view(which){ $('out').style.display = which==='json'?'block':'none';
  $('graph').style.display = which==='graph'?'block':'none'; if(which==='graph') draw(); }
let lats = [];
async function run(){
  const q = $('q').value; const t0 = performance.now();
  const dbg = $('dbg').checked ? '?debug=true' : '';
  const r = await fetch('/query' + dbg, {method:'POST', body:q});
  const j = await r.json(); last = j;
  $('out').textContent = JSON.stringify(j, null, 2);
  const sl = j.server_latency || {};
  const rt = performance.now() - t0;
  $('lat').textContent = 'server ' + (sl.total||'-') + ' · round-trip ' + rt.toFixed(1) + 'ms';
  lats = lats.concat([rt]).slice(-40); spark();
  // engine per-stage breakdown (debug=true): fusion + device/host split
  $('engstats').textContent = sl.engine ? Object.entries(sl.engine)
    .map(([k,v])=>k+': '+v).join('   ') : '';
  hist(q); view('json'); refreshSide();
}
function spark(){
  const svg = $('spark'); svg.innerHTML = '';
  if (!lats.length) return;
  const w = svg.clientWidth || 250, bw = Math.max(2, w/40 - 1), mx = Math.max(...lats);
  const NS = 'http://www.w3.org/2000/svg';
  lats.forEach((v,i)=>{
    const h = Math.max(2, 30*v/mx), r = document.createElementNS(NS,'rect');
    r.setAttribute('x', i*(bw+1)); r.setAttribute('y', 32-h);
    r.setAttribute('width', bw); r.setAttribute('height', h);
    const t = document.createElementNS(NS,'title');
    t.textContent = v.toFixed(1)+'ms'; r.appendChild(t);
    svg.appendChild(r);
  });
}
async function refreshSide(){
  try {
    // index/tokenizer/reverse/count must be requested explicitly (the
    // engine defaults schema{} to the type field alone); both fetches
    // are independent, so they run concurrently
    const [sr, dr] = await Promise.all([
      fetch('/query', {method:'POST',
        body:'schema { type index tokenizer reverse count }'}),
      fetch('/debug/store'),
    ]);
    const sj = await sr.json();
    const st = $('schema'); st.innerHTML = '';
    (sj.schema||[]).forEach(p=>{
      const tr = document.createElement('tr');
      // textContent throughout: schema strings must never execute
      [p.predicate, p.type + (p.index?' @index('+(p.tokenizer||[]).join(',')+')':'')
        + (p.reverse?' @reverse':'') + (p.count?' @count':'')]
        .forEach(txt=>{ const td=document.createElement('td'); td.textContent=txt; tr.appendChild(td); });
      st.appendChild(tr);
    });
    const dj = await dr.json();
    const tbl = $('stats'); tbl.innerHTML = '';
    Object.entries(dj).forEach(([k,v])=>{
      if (typeof v === 'object') return;
      const tr = document.createElement('tr');
      [k, String(v)].forEach(txt=>{ const td=document.createElement('td');
        td.textContent=txt; tr.appendChild(td); });
      tbl.appendChild(tr);
    });
  } catch(e) {}
}
function hist(q){
  let h = JSON.parse(localStorage.getItem('dgh')||'[]');
  h = [q].concat(h.filter(x=>x!==q)).slice(0,8);
  localStorage.setItem('dgh', JSON.stringify(h)); renderHist();
}
function renderHist(){
  const h = JSON.parse(localStorage.getItem('dgh')||'[]');
  const el = $('hist'); el.innerHTML = '';
  h.forEach((q,i)=>{
    const d = document.createElement('div');
    d.textContent = q.replace(/\s+/g,' ').slice(0,90);  // textContent: query text must never execute
    d.onclick = ()=>loadHist(i);
    el.appendChild(d);
  });
}
function loadHist(i){ $('q').value = JSON.parse(localStorage.getItem('dgh')||'[]')[i]; }
async function share(){
  const r = await fetch('/share', {method:'POST', body:$('q').value});
  const j = await r.json();
  $('lat').textContent = 'share id: ' + (j.uids&&j.uids.share);
}
function draw(){
  // tiny force layout over nodes/edges found in the last result tree
  const svg = $('graph'); svg.innerHTML=''; if(!last) return;
  const nodes = new Map(), edges = [];
  (function walk(obj, parentKey){
    if (Array.isArray(obj)) return obj.forEach(o=>walk(o, parentKey));
    if (typeof obj !== 'object' || !obj) return;
    const id = obj._uid_ || obj.name || JSON.stringify(obj).slice(0,24);
    if (!nodes.has(id)) nodes.set(id, {id, label: obj.name || id,
      x: Math.random()*600+50, y: Math.random()*400+50, vx:0, vy:0});
    if (parentKey) edges.push([parentKey, id]);
    for (const [k,v] of Object.entries(obj))
      if (typeof v === 'object') walk(v, id);
  })(last, null);
  const ns = [...nodes.values()];
  for (let it=0; it<120; it++){
    for (const a of ns) for (const b of ns){ if(a===b) continue;
      let dx=a.x-b.x, dy=a.y-b.y, d2=dx*dx+dy*dy+0.01, f=800/d2;
      a.vx+=dx*f*0.01; a.vy+=dy*f*0.01; }
    for (const [s,t] of edges){ const a=nodes.get(s), b=nodes.get(t); if(!a||!b) continue;
      let dx=b.x-a.x, dy=b.y-a.y;
      a.vx+=dx*0.002; a.vy+=dy*0.002; b.vx-=dx*0.002; b.vy-=dy*0.002; }
    for (const n of ns){ n.x+=n.vx; n.y+=n.vy; n.vx*=0.85; n.vy*=0.85; }
  }
  const NS='http://www.w3.org/2000/svg';
  for (const [s,t] of edges){ const a=nodes.get(s), b=nodes.get(t); if(!a||!b) continue;
    const l=document.createElementNS(NS,'line');
    l.setAttribute('x1',a.x); l.setAttribute('y1',a.y);
    l.setAttribute('x2',b.x); l.setAttribute('y2',b.y); svg.appendChild(l); }
  for (const n of ns){
    const c=document.createElementNS(NS,'circle');
    c.setAttribute('cx',n.x); c.setAttribute('cy',n.y); c.setAttribute('r',6); svg.appendChild(c);
    const t=document.createElementNS(NS,'text');
    t.setAttribute('x',n.x+8); t.setAttribute('y',n.y+4); t.textContent=n.label; svg.appendChild(t); }
}
renderHist(); refreshSide(); setInterval(refreshSide, 15000);
</script>
</body>
</html>
"""
