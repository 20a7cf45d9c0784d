// Minimal WebGL triangle-mesh viewer with shared-camera sync.
// No external dependencies (zero-egress environments): shaders, arcball and
// per-vertex-color Lambert shading implemented from scratch. The shared
// `Camera` object replicates the reference app's client-side camera sync
// (Visualizer/assets/clientside.js).

"use strict";

const VSHADER = `
attribute vec3 aPos;
attribute vec3 aNormal;
attribute vec3 aColor;
uniform mat4 uMVP;
uniform mat4 uModel;
varying vec3 vColor;
varying vec3 vNormal;
void main() {
  gl_Position = uMVP * vec4(aPos, 1.0);
  vNormal = mat3(uModel) * aNormal;
  vColor = aColor;
}`;

const FSHADER = `
precision mediump float;
varying vec3 vColor;
varying vec3 vNormal;
uniform float uEdge;
void main() {
  if (uEdge > 0.5) { gl_FragColor = vec4(0.02, 0.02, 0.04, 1.0); return; }
  vec3 n = normalize(vNormal);
  vec3 l1 = normalize(vec3(0.5, 0.7, 1.0));
  vec3 l2 = normalize(vec3(-0.6, -0.3, -0.8));
  float d = 0.35 + 0.55 * max(dot(n, l1), 0.0) + 0.25 * max(dot(n, l2), 0.0);
  gl_FragColor = vec4(vColor * d, 1.0);
}`;

// global edge-display toggle (reference generic viewer's showEdges,
// app.py:1266) — redraws every viewer when flipped
const Wireframe = {
  on: false,
  set(v) { this.on = v; Camera.changed(); },
};

// ---- tiny mat4 helpers ----
function mat4mul(a, b) {
  const o = new Float32Array(16);
  for (let i = 0; i < 4; i++)
    for (let j = 0; j < 4; j++) {
      let s = 0;
      for (let k = 0; k < 4; k++) s += a[k * 4 + j] * b[i * 4 + k];
      o[i * 4 + j] = s;
    }
  return o;
}
function mat4perspective(fov, aspect, near, far) {
  const f = 1 / Math.tan(fov / 2);
  const o = new Float32Array(16);
  o[0] = f / aspect; o[5] = f;
  o[10] = (far + near) / (near - far); o[11] = -1;
  o[14] = (2 * far * near) / (near - far);
  return o;
}
function mat4rotXY(rx, ry) {
  const cx = Math.cos(rx), sx = Math.sin(rx);
  const cy = Math.cos(ry), sy = Math.sin(ry);
  // rotY then rotX
  return new Float32Array([
    cy, sx * sy, -cx * sy, 0,
    0, cx, sx, 0,
    sy, -sx * cy, cx * cy, 0,
    0, 0, 0, 1,
  ]);
}
function mat4translate(z) {
  const o = new Float32Array(16);
  o[0] = o[5] = o[10] = o[15] = 1;
  o[14] = z;
  return o;
}

// ---- shared camera ----
const Camera = {
  rx: 0.4, ry: 0.6, dist: 3.0,
  listeners: [],
  onChange(fn) { this.listeners.push(fn); },
  changed() { for (const fn of this.listeners) fn(); },
};

class MeshViewer {
  constructor(canvas) {
    this.canvas = canvas;
    // preserveDrawingBuffer so toDataURL (PNG export) sees the last frame
    const gl = canvas.getContext("webgl", { preserveDrawingBuffer: true });
    this.gl = gl;
    this.nIndices = 0;
    const prog = gl.createProgram();
    for (const [type, src] of [[gl.VERTEX_SHADER, VSHADER], [gl.FRAGMENT_SHADER, FSHADER]]) {
      const sh = gl.createShader(type);
      gl.shaderSource(sh, src);
      gl.compileShader(sh);
      if (!gl.getShaderParameter(sh, gl.COMPILE_STATUS))
        throw new Error(gl.getShaderInfoLog(sh));
      gl.attachShader(prog, sh);
    }
    gl.linkProgram(prog);
    this.prog = prog;
    this.buffers = { pos: gl.createBuffer(), nor: gl.createBuffer(), col: gl.createBuffer(), idx: gl.createBuffer(), edge: gl.createBuffer() };
    this.nEdgeIndices = 0;
    this.attachControls();
    Camera.onChange(() => this.draw());
  }

  attachControls() {
    const c = this.canvas;
    let drag = false, px = 0, py = 0;
    c.addEventListener("mousedown", (e) => { drag = true; px = e.clientX; py = e.clientY; });
    window.addEventListener("mouseup", () => { drag = false; });
    window.addEventListener("mousemove", (e) => {
      if (!drag) return;
      Camera.ry += (e.clientX - px) * 0.01;
      Camera.rx += (e.clientY - py) * 0.01;
      px = e.clientX; py = e.clientY;
      Camera.changed();
    });
    c.addEventListener("wheel", (e) => {
      e.preventDefault();
      Camera.dist *= Math.exp(e.deltaY * 0.001);
      Camera.dist = Math.min(20, Math.max(0.5, Camera.dist));
      Camera.changed();
    }, { passive: false });
  }

  // vertices: Float32Array flat xyz; faces: Int32Array flat; colors: flat rgb
  setMesh(vertices, faces, colors) {
    const gl = this.gl;
    const nv = vertices.length / 3;
    // per-vertex normals from face normals
    const normals = new Float32Array(vertices.length);
    for (let f = 0; f < faces.length; f += 3) {
      const a = faces[f] * 3, b = faces[f + 1] * 3, c = faces[f + 2] * 3;
      const ux = vertices[b] - vertices[a], uy = vertices[b + 1] - vertices[a + 1], uz = vertices[b + 2] - vertices[a + 2];
      const vx = vertices[c] - vertices[a], vy = vertices[c + 1] - vertices[a + 1], vz = vertices[c + 2] - vertices[a + 2];
      const nx = uy * vz - uz * vy, ny = uz * vx - ux * vz, nz = ux * vy - uy * vx;
      for (const i of [a, b, c]) { normals[i] += nx; normals[i + 1] += ny; normals[i + 2] += nz; }
    }
    for (let i = 0; i < nv; i++) {
      const m = Math.hypot(normals[3 * i], normals[3 * i + 1], normals[3 * i + 2]) || 1;
      normals[3 * i] /= m; normals[3 * i + 1] /= m; normals[3 * i + 2] /= m;
    }
    const up = (buf, data) => { gl.bindBuffer(gl.ARRAY_BUFFER, buf); gl.bufferData(gl.ARRAY_BUFFER, data, gl.STATIC_DRAW); };
    up(this.buffers.pos, vertices);
    up(this.buffers.nor, normals);
    up(this.buffers.col, colors);
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, this.buffers.idx);
    // 10242 vertices fit in uint16
    const idx = nv < 65536 ? new Uint16Array(faces) : new Uint32Array(faces);
    this.indexType = nv < 65536 ? gl.UNSIGNED_SHORT : gl.UNSIGNED_INT;
    if (this.indexType === gl.UNSIGNED_INT) gl.getExtension("OES_element_index_uint");
    gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, idx, gl.STATIC_DRAW);
    this.nIndices = faces.length;
    // wireframe edge list (deduped: keep each undirected edge once)
    const seen = new Set();
    const edges = [];
    for (let f = 0; f < faces.length; f += 3) {
      for (const [a, b] of [[faces[f], faces[f + 1]], [faces[f + 1], faces[f + 2]], [faces[f + 2], faces[f]]]) {
        const key = a < b ? a * 16777216 + b : b * 16777216 + a;
        if (!seen.has(key)) { seen.add(key); edges.push(a, b); }
      }
    }
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, this.buffers.edge);
    gl.bufferData(gl.ELEMENT_ARRAY_BUFFER,
      nv < 65536 ? new Uint16Array(edges) : new Uint32Array(edges), gl.STATIC_DRAW);
    this.nEdgeIndices = edges.length;
    this.draw();
  }

  draw() {
    const gl = this.gl;
    const w = this.canvas.width, h = this.canvas.height;
    gl.viewport(0, 0, w, h);
    gl.clearColor(0.09, 0.1, 0.12, 1);
    gl.enable(gl.DEPTH_TEST);
    gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
    if (!this.nIndices) return;
    gl.useProgram(this.prog);
    const model = mat4rotXY(Camera.rx, Camera.ry);
    const mvp = mat4mul(mat4mul(mat4perspective(0.8, w / h, 0.1, 100), mat4translate(-Camera.dist)), model);
    gl.uniformMatrix4fv(gl.getUniformLocation(this.prog, "uMVP"), false, mvp);
    gl.uniformMatrix4fv(gl.getUniformLocation(this.prog, "uModel"), false, model);
    const bind = (name, buf) => {
      const loc = gl.getAttribLocation(this.prog, name);
      gl.bindBuffer(gl.ARRAY_BUFFER, buf);
      gl.enableVertexAttribArray(loc);
      gl.vertexAttribPointer(loc, 3, gl.FLOAT, false, 0, 0);
    };
    bind("aPos", this.buffers.pos);
    bind("aNormal", this.buffers.nor);
    bind("aColor", this.buffers.col);
    const uEdge = gl.getUniformLocation(this.prog, "uEdge");
    gl.uniform1f(uEdge, 0);
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, this.buffers.idx);
    if (Wireframe.on) {  // push faces back so edges win the depth test
      gl.enable(gl.POLYGON_OFFSET_FILL);
      gl.polygonOffset(1.0, 1.0);
    }
    gl.drawElements(gl.TRIANGLES, this.nIndices, this.indexType, 0);
    gl.disable(gl.POLYGON_OFFSET_FILL);
    if (Wireframe.on && this.nEdgeIndices) {
      gl.uniform1f(uEdge, 1);
      gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, this.buffers.edge);
      gl.drawElements(gl.LINES, this.nEdgeIndices, this.indexType, 0);
    }
  }
}
