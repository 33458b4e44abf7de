"""Minimal inference server over an exported serving bundle.

Counterpart of `sednet_tpu/serve.py`: a single-process HTTP server that
loads a bundle (`export.load_bundle`: the type and instance programs),
pads incoming point clouds to the exported (B, N, C) shape, runs the
forward(s), optionally clusters the instance embedding with the guarded
mean-shift, and returns JSON.

  * The bundle's shape is static: requests are padded up to B shapes of N
    points each and the response slices back to the true lengths. Padding
    repeats the last real point, an approximation for short clouds (pad
    copies can enter real points' kNN neighbourhoods). Clustering runs on
    the real-length slice only. Clouds longer than the bundle's N are
    rejected.
  * stdlib http.server only; the handler is single-threaded and the
    predictions hold a lock, so requests reach the card one at a time.
  * Protocol: POST /predict, body JSON {"points": [[x,y,z,(nx,ny,nz)] ...]
    per shape} (one shape may be given flat) or an npz payload
    (Content-Type: application/x-npz, array "points" (B', N', C), and,
    beyond JAX's protocol, an optional "lengths" (B',) that cuts shape i to
    its first lengths[i] points, so that one npz carries clouds of
    several lengths);
    response JSON {"results": [{"types", "edges"?, "instances"?,
    "num_instances"?} per shape]}; a bad request gets 400 with its error.
    GET /health answers the bundle's shape, and logs one JSON line with
    the kernels' launch counts in this process (`tracing.kernel_launches`).
  * Random inputs (each shape's LOBPCG start block and mean-shift
    subsamples) come from one `torch.Generator` seeded 0, advanced once per
    clustered request (`request_generators`), in place of JAX's
    PRNGKey(0) split per request and folded in per shape.

CLI:
    python -m sednet_tpu_torch.serve bundle_dir [--port 8765] [--cluster]
        [--device cuda]
"""
from __future__ import annotations

import dataclasses
import io
import json
import logging
import threading

import numpy as np
import torch

from sednet_tpu_torch.config import Config
from sednet_tpu_torch.device import resolve_device

logger = logging.getLogger("sednet_tpu_torch.serve")


def request_generators(gen: torch.Generator, n: int) -> list:
    """One request's per-shape generators: gen advanced by one draw, whose
    value seeds shape i's generator as value + i."""
    base = int(torch.randint(0, 2 ** 62, (), generator=gen))
    return [torch.Generator().manual_seed(base + i) for i in range(n)]


def cluster_shape(emb, xyz, normals, cfg: Config, generator):
    """One shape's instance labels as the server computes them: the HPNet
    enrichment when cfg.hpnet_embed and normals are given
    (`predict.spectral_embed`, `cluster.spectral.hpnet_process`), the rows
    L2-normalised, then `guard_mean_shift` under cfg's ms_* knobs (the
    predict pipeline's, `sednet_tpu/serve.py:117-138`). Returns its
    MeanShiftResult."""
    from sednet_tpu_torch.cluster.mean_shift import guard_mean_shift
    from sednet_tpu_torch.cluster.spectral import hpnet_process
    from sednet_tpu_torch.predict import spectral_embed

    n = emb.shape[0]
    if cfg.hpnet_embed and normals is not None:
        v, ent = spectral_embed(xyz, normals, cfg, generator=generator)
        emb = hpnet_process(emb, xyz, normals,
                            normal_smooth_w=cfg.normal_smooth_w,
                            cached_eigvecs=v, cached_eig_entropy=ent)
    emb = emb / torch.clamp_min(emb.norm(dim=-1, keepdim=True), 1e-12)
    return guard_mean_shift(
        emb, num_samples=min(cfg.ms_num_samples, n),
        quantile=cfg.ms_quantile, iterations=cfg.ms_iterations,
        max_clusters=cfg.ms_max_clusters - 1,
        retry_factor=cfg.ms_retry_factor, tol=cfg.ms_tol,
        generator=generator)


class BundleServer:
    """Wraps a loaded bundle with padding and batching, and optional
    clustering with the knobs of the bundle's config snapshot."""

    def __init__(self, bundle_dir: str, *, cluster: bool = False,
                 device=None):
        from sednet_tpu_torch.export import load_bundle

        self.bundle_dir = bundle_dir
        self.device = resolve_device(device)
        self.meta, self.fns = load_bundle(bundle_dir, self.device)
        self.cluster = cluster
        known = {f.name for f in dataclasses.fields(Config)}
        self.cfg = Config(**{k: v for k, v in self.meta["config"].items()
                             if k in known})
        if cluster and self.cfg.ms_bf16:
            raise NotImplementedError("ms_bf16: the bf16 mean-shift is not "
                                      "ported")
        # exported input spec: "float32[B,N,C]"
        spec = self.meta["models"]["type_model"]["in_avals"][0]
        dims = spec[spec.index("[") + 1:spec.index("]")].split(",")
        self.batch, self.num_points, self.channels = map(int, dims)
        self._gen = torch.Generator().manual_seed(0)
        self._lock = threading.Lock()

    def _pad(self, shapes: list[np.ndarray]) -> tuple[np.ndarray, list[int]]:
        if len(shapes) > self.batch:
            raise ValueError(
                f"got {len(shapes)} shapes; artifact batch is {self.batch}")
        x = np.zeros((self.batch, self.num_points, self.channels),
                     np.float32)
        lengths = []
        for i, s in enumerate(shapes):
            s = np.asarray(s, np.float32)
            if s.ndim != 2 or s.shape[1] != self.channels:
                raise ValueError(
                    f"shape {i}: expected (n, {self.channels}), got {s.shape}")
            n = s.shape[0]
            if n < 1:
                raise ValueError(f"shape {i}: empty point cloud")
            if n > self.num_points:
                raise ValueError(
                    f"shape {i}: {n} points exceeds the artifact's "
                    f"{self.num_points} (re-export at a larger shape)")
            x[i, :n] = s
            if n < self.num_points:   # repeat the last real point
                x[i, n:] = s[n - 1]
            lengths.append(n)
        for i in range(len(shapes), self.batch):  # pad batch with shape 0
            x[i] = x[0]
        return x, lengths

    @torch.no_grad()
    def predict(self, shapes: list[np.ndarray]) -> list[dict]:
        x, lengths = self._pad(shapes)
        xt = torch.from_numpy(x).to(self.device)
        with self._lock:
            tout = self.fns["type_model"](xt)
            types = tout["type_log_prob"].argmax(-1).cpu().numpy()
            results = [{"types": types[i, :lengths[i]].tolist()}
                       for i in range(len(shapes))]
            if "edge_logits" in tout:
                edges = tout["edge_logits"].argmax(-1).cpu().numpy()
                for i, r in enumerate(results):
                    r["edges"] = edges[i, :lengths[i]].tolist()
            if self.cluster:
                iout = self.fns["inst_model"](xt)
                gens = request_generators(self._gen, len(shapes))
                for i in range(len(shapes)):
                    # the real-length slice only: padded duplicate rows
                    # would collapse the bandwidth estimate
                    n = lengths[i]
                    res = cluster_shape(
                        iout["embedding"][i, :n], xt[i, :n, :3],
                        xt[i, :n, 3:6] if self.channels >= 6 else None,
                        self.cfg, gens[i])
                    results[i]["instances"] = res.labels.cpu().tolist()
                    results[i]["num_instances"] = int(res.num_clusters)
        return results


def _parse_body(content_type: str, body: bytes) -> list[np.ndarray]:
    if content_type.startswith("application/x-npz"):
        with np.load(io.BytesIO(body)) as d:
            pts = d["points"]
            lengths = d["lengths"] if "lengths" in d.files else None
        if lengths is None:
            return [pts[i] for i in range(pts.shape[0])]
        if lengths.shape != pts.shape[:1]:
            raise ValueError(f"lengths {lengths.shape} for points "
                             f"{pts.shape}: one length a shape")
        return [pts[i, :int(n)] for i, n in enumerate(lengths)]
    payload = json.loads(body)
    shapes = payload["points"]
    if shapes and not isinstance(shapes[0][0], (list, tuple)):
        shapes = [shapes]   # single shape given flat
    return [np.asarray(s, np.float32) for s in shapes]


def make_http_server(server: BundleServer, port: int = 8765):
    from http.server import BaseHTTPRequestHandler, HTTPServer

    from sednet_tpu_torch.utils.tracing import kernel_launches

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, obj):
            blob = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/health":
                print(json.dumps({"health": "ok",
                                  "launches": kernel_launches()}),
                      flush=True)
                self._send(200, {"ok": True,
                                 "batch": server.batch,
                                 "num_points": server.num_points,
                                 "channels": server.channels})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                shapes = _parse_body(
                    self.headers.get("Content-Type", ""),
                    self.rfile.read(n))
                self._send(200, {"results": server.predict(shapes)})
            except Exception as e:  # noqa: BLE001 — report to client
                logger.exception("bad request")
                self._send(400, {"error": str(e)})

    return HTTPServer(("127.0.0.1", port), Handler)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("bundle")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--cluster", action="store_true",
                    help="also mean-shift the instance embedding")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu: the bundle's device")
    args = ap.parse_args(argv)
    srv = BundleServer(args.bundle, cluster=args.cluster, device=args.device)
    httpd = make_http_server(srv, args.port)
    print(json.dumps({"serving": args.bundle,
                      "port": httpd.server_address[1],
                      "batch": srv.batch, "num_points": srv.num_points}),
          flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
