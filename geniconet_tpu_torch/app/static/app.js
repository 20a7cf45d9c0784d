// Frontend logic: wires the control panel to the JSON API and the viewers.
"use strict";

const viewerA = new MeshViewer(document.getElementById("canvasA"));
const viewerB = new MeshViewer(document.getElementById("canvasB"));
let INFO = null;
let PCA = null;

const $ = (id) => document.getElementById(id);
const status = (msg) => { $("status").textContent = msg; };

async function api(path, body) {
  const r = await fetch(path, { method: "POST", headers: { "Content-Type": "application/json" }, body: JSON.stringify(body || {}) });
  const j = await r.json();
  if (j.error) { status("error: " + j.error); throw new Error(j.error); }
  return j;
}

function showMesh(viewer, m) {
  viewer.setMesh(new Float32Array(m.vertices), new Int32Array(m.faces), new Float32Array(m.colors));
}

function coloring() { return $("coloring").value; }
function selI() { return parseInt($("selI").value); }
function selJ() { return parseInt($("selJ").value); }

async function refresh() {
  const i = selI();
  const [ref, rec] = await Promise.all([
    api("/api/mesh", { i, which: "reference", coloring: "none" }),
    api("/api/mesh", { i, which: "recon", coloring: coloring() }),
  ]);
  $("paneTitleA").textContent = `reference — ${INFO.names[i]}`;
  $("paneTitleB").textContent = `reconstruction — ${INFO.names[i]}`;
  showMesh(viewerA, ref);
  showMesh(viewerB, rec);
}

async function init() {
  try {
    INFO = await api("/api/info", {});
  } catch (e) {
    status("no model loaded — start the server with --model/--logDir (or --synthetic), or POST /api/load");
    return;
  }
  $("modelInfo").textContent =
    `${INFO.is_vae ? "VAE" : "AE"} epoch ${INFO.epoch} — ${INFO.n} meshes, ` +
    `latent ${INFO.latent_shape.join("×")}`;
  for (const sel of ["selI", "selJ", "arithJ", "arithK"]) {
    const el = $(sel);
    el.innerHTML = "";
    INFO.names.forEach((n, k) => {
      const o = document.createElement("option");
      o.value = k; o.textContent = `${k}: ${n}`;
      el.appendChild(o);
    });
  }
  $("selJ").value = Math.min(1, INFO.n - 1);
  $("arithJ").value = Math.min(1, INFO.n - 1);
  $("arithK").value = Math.min(2, INFO.n - 1);
  if (!INFO.is_vae) $("fsRegen").style.display = "none";
  // patch checkboxes
  const pb = $("patchBoxes");
  pb.innerHTML = "";
  for (let c = 0; c < 5; c++) {
    const l = document.createElement("label");
    const cb = document.createElement("input");
    cb.type = "checkbox"; cb.dataset.chart = c;
    l.appendChild(cb); l.appendChild(document.createTextNode(" " + c));
    pb.appendChild(l);
  }
  await refresh();
  await drawPCA();
  await fillEpochs();
  await fillViewpoints();
  status("ready");
}

// 3-D PCA scatter with class colors + drag rotation (reference
// visualizer_utils.py:123-161 create_3d_figure parity): points are rotated
// by yaw/pitch, depth-sorted, and drawn with perspective size/alpha cues;
// a click (without drag) decodes the nearest latent in full 3-D space.
const pcaView = { yaw: 0.6, pitch: 0.35 };
async function drawPCA() {
  if (!PCA) PCA = await api("/api/pca", {});
  const cv = $("pcaCanvas"), ctx = cv.getContext("2d");
  ctx.clearRect(0, 0, cv.width, cv.height);
  const pts = PCA.points;
  // center + scale once
  if (!PCA._norm) {
    const c = [0, 1, 2].map(a => pts.reduce((s, p) => s + p[a], 0) / pts.length);
    let r = 0;
    pts.forEach(p => { r = Math.max(r, Math.hypot(p[0] - c[0], p[1] - c[1], p[2] - c[2])); });
    PCA._norm = { c, r: r + 1e-9 };
  }
  const { c, r } = PCA._norm;
  const cy = Math.cos(pcaView.yaw), sy = Math.sin(pcaView.yaw);
  const cp = Math.cos(pcaView.pitch), sp = Math.sin(pcaView.pitch);
  const classes = [...new Set(PCA.classes)];
  const palette = ["#d45e00", "#009e73", "#56b4e9", "#f0e442", "#cc79a7", "#0072b2", "#e69f00"];
  const half = Math.min(cv.width, cv.height) / 2 - 14;
  // rotate, project, depth-sort (painter's order)
  PCA._screen = pts.map((p, k) => {
    const x0 = (p[0] - c[0]) / r, y0 = (p[1] - c[1]) / r, z0 = (p[2] - c[2]) / r;
    const x1 = cy * x0 + sy * z0, z1 = -sy * x0 + cy * z0;       // yaw
    const y2 = cp * y0 - sp * z1, z2 = sp * y0 + cp * z1;        // pitch
    const persp = 1.6 / (2.4 - z2);
    return { k, x: cv.width / 2 + x1 * half * persp, y: cv.height / 2 - y2 * half * persp, z: z2 };
  }).sort((a, b) => a.z - b.z);
  // faint axis tripod for orientation
  ctx.strokeStyle = "#444"; ctx.lineWidth = 1;
  [[1, 0, 0], [0, 1, 0], [0, 0, 1]].forEach(ax => {
    const x1 = cy * ax[0] + sy * ax[2], z1 = -sy * ax[0] + cy * ax[2];
    const y2 = cp * ax[1] - sp * z1;
    ctx.beginPath(); ctx.moveTo(cv.width / 2, cv.height / 2);
    ctx.lineTo(cv.width / 2 + x1 * half * 0.5, cv.height / 2 - y2 * half * 0.5); ctx.stroke();
  });
  PCA._screen.forEach(s => {
    const depth = (s.z + 1) / 2;  // 0 far .. 1 near
    ctx.globalAlpha = 0.45 + 0.55 * depth;
    ctx.fillStyle = palette[classes.indexOf(PCA.classes[s.k]) % palette.length];
    ctx.beginPath(); ctx.arc(s.x, s.y, 2.5 + 2.5 * depth, 0, 6.3); ctx.fill();
  });
  ctx.globalAlpha = 1;
  // class legend
  classes.forEach((cl, j) => {
    ctx.fillStyle = palette[j % palette.length];
    ctx.fillRect(6, 8 + 14 * j, 9, 9);
    ctx.fillStyle = "#ccc"; ctx.font = "10px sans-serif";
    ctx.fillText(cl, 19, 16 + 14 * j);
  });

  if (cv._pcaWired) return;
  cv._pcaWired = true;
  let drag = null;
  cv.onmousedown = (e) => { drag = { x: e.clientX, y: e.clientY, moved: false }; };
  window.addEventListener("mousemove", (e) => {
    if (!drag) return;
    const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
    if (Math.abs(dx) + Math.abs(dy) > 2) drag.moved = true;
    pcaView.yaw += dx * 0.012;
    pcaView.pitch = Math.max(-1.5, Math.min(1.5, pcaView.pitch + dy * 0.012));
    drag.x = e.clientX; drag.y = e.clientY;
    drawPCA();
  });
  window.addEventListener("mouseup", async (e) => {
    if (!drag) return;
    const wasClick = !drag.moved;
    drag = null;
    if (!wasClick) return;
    const rct = cv.getBoundingClientRect();
    const mx = e.clientX - rct.left, my = e.clientY - rct.top;
    let best = -1, bd = 400;  // require a hit within 20px
    PCA._screen.forEach(s => {
      const d = (s.x - mx) ** 2 + (s.y - my) ** 2;
      if (d < bd) { bd = d; best = s.k; }
    });
    if (best < 0) return;
    const m = await api("/api/pca_decode", { p: PCA.points[best], coloring: coloring() });
    $("paneTitleB").textContent = `PCA-NN decode — ${m.name}`;
    showMesh(viewerB, m);
    status(`decoded nearest latent: ${m.name}`);
  });
}

// ---- control wiring ----
$("btnShow").onclick = refresh;
$("coloring").onchange = refresh;
$("selI").onchange = refresh;

// wireframe toggle (reference generic viewer's showEdges, app.py:1266)
$("wireframe").onchange = (e) => Wireframe.set(e.target.checked);

// checkpoint-epoch dropdown (reference update_epoch_list, app.py:54-96)
async function fillEpochs() {
  const eps = await api("/api/epochs", {});
  const sel = $("epochSel");
  sel.innerHTML = "";
  for (const e of eps.best.slice().reverse()) {
    const o = document.createElement("option");
    o.value = e; o.textContent = `EB${e} (best)`;
    sel.appendChild(o);
  }
  for (const e of eps.periodic.slice().reverse()) {
    const o = document.createElement("option");
    o.value = e; o.textContent = `E${e}`;
    sel.appendChild(o);
  }
}
$("btnLoadEpoch").onclick = async () => {
  status("loading epoch " + $("epochSel").value + " ...");
  await api("/api/load", {
    model: INFO.model, logDir: INFO.logDir, dataDir: INFO.dataDir,
    synthetic: INFO.synthetic, subdivision: INFO.subdivisions,
    epoch: parseInt($("epochSel").value),
  });
  PCA = null;
  await init();
};

// saved viewpoints (reference update_viewpoint_list, app.py:612-628)
async function fillViewpoints() {
  const r = await api("/api/viewpoint", { op: "list" });
  const sel = $("vpSel");
  sel.innerHTML = "";
  for (const name of Object.keys(r.viewpoints)) {
    const o = document.createElement("option");
    o.value = name; o.textContent = name;
    sel.appendChild(o);
  }
  return r.viewpoints;
}
$("btnVpSave").onclick = async () => {
  const name = $("vpName").value.trim() || `view_${Date.now() % 100000}`;
  await api("/api/viewpoint", {
    op: "save", name,
    camera: { rx: Camera.rx, ry: Camera.ry, dist: Camera.dist },
  });
  await fillViewpoints();
  $("vpSel").value = name;
  status(`viewpoint '${name}' saved`);
};
$("btnVpApply").onclick = async () => {
  const vps = await fillViewpoints();
  const vp = vps[$("vpSel").value];
  if (!vp) return;
  Camera.rx = vp.rx; Camera.ry = vp.ry; Camera.dist = vp.dist;
  Camera.changed();
  status(`viewpoint '${$("vpSel").value}' applied`);
};

$("interpT").oninput = async (e) => {
  const t = parseFloat(e.target.value);
  $("interpVal").textContent = `t = ${t}`;
  const m = await api("/api/interpolate", { i: selI(), j: selJ(), t, coloring: coloring() });
  $("paneTitleB").textContent = `interpolation t=${t}`;
  showMesh(viewerB, m);
};

$("btnArith").onclick = async () => {
  const terms = [{ op: "+", i: selI() }, { op: $("arithOp2").value, i: parseInt($("arithJ").value) }];
  if ($("arithOp3").value) terms.push({ op: $("arithOp3").value, i: parseInt($("arithK").value) });
  const m = await api("/api/arithmetic", { terms, coloring: coloring() });
  $("paneTitleB").textContent = "latent arithmetic";
  $("arithNN").textContent = `nearest dataset latent: ${m.nearest.name}`;
  showMesh(viewerB, m);
};

$("chanDelta").oninput = async (e) => {
  const d = parseFloat(e.target.value);
  $("chanVal").textContent = `Δ = ${d}σ`;
  const m = await api("/api/explore", {
    i: selI(), channel: parseInt($("chanIdx").value), delta: d,
    noise: parseFloat($("chanNoise").value || 0), coloring: coloring(),
  });
  $("paneTitleB").textContent = `channel ${$("chanIdx").value} shifted ${d}σ`;
  showMesh(viewerB, m);
};

$("regenK").oninput = (e) => { $("regenVal").textContent = `k = ${e.target.value}`; };
$("btnRegen").onclick = async () => {
  const m = await api("/api/regenerate", {
    i: selI(), k: parseFloat($("regenK").value),
    seed: Math.floor(Math.random() * 1e6), coloring: coloring(),
  });
  $("paneTitleB").textContent = "re-generation";
  showMesh(viewerB, m);
};

$("btnPatch").onclick = async () => {
  const patches = [...document.querySelectorAll("#patchBoxes input:checked")].map(cb => parseInt(cb.dataset.chart));
  const m = await api("/api/patch_combine", { i: selI(), j: selJ(), patches });
  $("paneTitleB").textContent = `patches ${patches.join(",")} from j`;
  showMesh(viewerB, m);
};

async function pairs(farthest) {
  const r = await api("/api/pairs", { k: 5, farthest });
  $("pairsOut").innerHTML = r.pairs.map(p =>
    `<div>${INFO.names[p.i]} ↔ ${INFO.names[p.j]} (d=${p.d.toFixed(3)})</div>`).join("");
}
$("btnPairsC").onclick = () => pairs(false);
$("btnPairsF").onclick = () => pairs(true);

$("btnViewFile").onclick = async () => {
  const m = await api("/api/view_file", { path: $("filePath").value });
  $("paneTitleB").textContent = `file: ${$("filePath").value}`;
  showMesh(viewerB, m);
};

$("btnExport").onclick = async () => {
  const r = await api("/api/export", { i: selI() });
  status("exported: " + r.path);
};

// server-side figure-object export (the plotly .pkl equivalent)
const figBtn = document.createElement("button");
figBtn.textContent = "export .fig.json";
figBtn.onclick = async () => {
  const r = await api("/api/export", { i: selI(), fmt: "fig", coloring: coloring() });
  status("exported figure: " + r.path);
};
$("btnExport").after(figBtn);

// client-side PNG export of the output pane (kaleido-free figure export)
const pngBtn = document.createElement("button");
pngBtn.textContent = "download output pane .png";
pngBtn.onclick = () => {
  viewerB.draw();  // ensure fresh frame (preserveDrawingBuffer not set)
  const c = document.getElementById("canvasB");
  requestAnimationFrame(() => {
    const a = document.createElement("a");
    a.download = "geniconet_output.png";
    a.href = c.toDataURL("image/png");
    a.click();
  });
};
$("btnExport").after(pngBtn);

init();
