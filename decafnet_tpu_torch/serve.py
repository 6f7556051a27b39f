"""Grounding service: weights resident on the device, requests answered one
video (or one stacked batch of videos) at a time (port of
decafnet_tpu/serve.py, ``GroundingService`` and ``service_from_logdir``, and
of the root ``serve.py``, the HTTP endpoint).

A request is one video's expert/sidekick clip features plus Q tokenized
queries; the answer is each query's top-k (start_sec, end_sec) segments and
scores. Requests are split into shape buckets (decafnet_tpu_torch.data) so
same-bucket videos can be stacked into one forward (:meth:`ground_many`).

HTTP endpoint, on the CUDA card unless ``--device`` says otherwise::

    python -m decafnet_tpu_torch.serve --name <experiment_dir> [--ckpt last]
        [--host 127.0.0.1] [--port 8787] [--warmup T,Q,L ...]
        [--set dotted.key value ...] [--device cuda|cpu]

  GET  /healthz       -> {"status": "ok", "device": ..., "n_devices": ...,
                          "phase_stats": GroundingService.stats()}
  POST /ground        -> {"detections": [{"segments": [[s, e], ...],
                                          "scores": [...]}, ...]}
  POST /ground_batch  -> {"detections_batch": [...]} for {"requests": [...]}

Request body (JSON), feature arrays inline (nested lists) or as .npy paths
the server can read: vid | vid_path (Cv, t); shallow_vid | shallow_vid_path
(Cs, t); texts (list of Q (Ct, l_q)) | texts_path (.npz, sorted entries);
text_cls | text_cls_path (Q, Cs); optional fps, clip_size, clip_stride,
duration, and ext_scores | ext_scores_path (Q, t).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .eval.evaluator import (Decoder, checkpoint_path, config_from_logdir,
                             resolve_device)
from .models import load_params, load_pth, make_model, require_two_heads
from .utils.profiling import SETUP, is_count


class GroundingService:
    """One video + Q queries -> detections in seconds.

    ``cfg``: a full config tree (``core.load_config``). Weights come from
    ``params``, a flax-layout parameter tree of numpy arrays, or from
    ``checkpoint``, a reference-layout ``.pth`` (its ``model_ema``).
    ``device``: None for the CUDA card, or an explicit device. The model
    computes in ``tpu.compute_dtype`` (f32 for "auto"; ``--set
    tpu.compute_dtype bfloat16`` serves in bf16).

    The decoder's record (``decoder.time_dict``) holds the decode's spans
    and counters (:mod:`eval.evaluator`) and the service's own:
    ``serve.queue``, the wait for the single-flight lock, and
    ``serve.answer``, the answers turned into lists. Building the service
    goes into the set-up record as ``setup.service``."""

    def __init__(self, cfg, params=None, checkpoint=None, device=None):
        require_two_heads(cfg, "GroundingService")
        if (params is None) == (checkpoint is None):
            raise ValueError("pass exactly one of params / checkpoint")
        with SETUP.phase("setup.service"):
            self.device = resolve_device(device)
            model = make_model(cfg)
            if params is not None:
                load_params(model, params)
            else:
                load_pth(model, checkpoint)
            self.model = model.to(self.device).eval()
            self._dec = Decoder(cfg, self.model, self.device)
        self._lock = threading.Lock()  # single-flight: decode serially
        self._stats_window = 512       # entries a summary reads

    @property
    def decoder(self):
        return self._dec

    @contextlib.contextmanager
    def _turn(self):
        """Hold the single-flight lock; the wait is ``serve.queue``."""
        with self._dec.timer.phase("serve.queue"):
            self._lock.acquire()
        try:
            yield
        finally:
            self._lock.release()

    def stats(self):
        """Per span or counter of the record, a summary of its last
        entries (at most 512): their number, and their mean and largest
        in ms (``mean_ms``, ``max_ms``), or as counts (``mean``, ``max``)
        for byte and row counters."""
        out = {}
        for k, v in list(self._dec.time_dict.items()):
            v = v[-self._stats_window:]
            if not v:
                continue
            if is_count(k):
                out[k] = {"n": len(v), "mean": round(sum(v) / len(v), 3),
                          "max": max(v)}
            else:
                out[k] = {"n": len(v),
                          "mean_ms": round(1e3 * sum(v) / len(v), 3),
                          "max_ms": round(1e3 * max(v), 3)}
        return out

    def warmup(self, vid_len, num_queries=1, text_len=8, vid_dim=None,
               shallow_dim=None, text_dim=None):
        """Run one request of the given shape bucket with zero features."""
        cfg = self._dec.cfg
        cv = vid_dim or cfg.model.vid_net.in_dim
        cs = shallow_dim or cv
        ct = text_dim or cfg.model.text_net.in_dim
        self.ground(
            vid=np.zeros((cv, vid_len), np.float32),
            shallow_vid=np.zeros((cs, vid_len), np.float32),
            texts=[np.zeros((ct, text_len), np.float32)] * num_queries,
            text_cls=np.zeros((num_queries, cs), np.float32))

    def ground_many(self, requests, max_group=8):
        """Ground a batch of requests (dicts of :meth:`ground` arguments),
        stacking same-bucket videos into one forward, padded to a power of
        two of videos with inert copies. Returns one detections list per
        request, as :meth:`ground` would."""
        prepared = [(i,) + self._prepare(**req) for i, req in enumerate(requests)]
        by_bucket = {}
        for i, _, items in prepared:
            for item in items:
                by_bucket.setdefault(Decoder.bucket_key(item), []).append((i, item))

        out = [[] for _ in requests]
        with self._turn():
            for tagged in by_bucket.values():
                for pos in range(0, len(tagged), max_group):
                    group = tagged[pos:pos + max_group]
                    v = 1
                    while v < len(group):
                        v *= 2
                    items = [it for _, it in group]
                    items += [{**items[0], "n_q": 0}] * (v - len(items))
                    for (req_i, item), (results, _) in zip(
                            group, self._dec.decode_group(items)):
                        out[req_i].append((item["q_start"], results))
        final = []
        with self._dec.timer.phase("serve.answer"):
            for (_, meta, _), chunks in zip(prepared, out):
                results = [None] * meta["num_queries"]
                for q_start, r in chunks:
                    results[q_start:q_start + len(r)] = r
                final.append(_as_lists(results))
        return final

    def _prepare(self, vid, shallow_vid, texts, text_cls, *, fps=30.0,
                 duration=None, clip_size=32, clip_stride=16, ext_scores=None):
        """Validate one request and split it into decode work items.

        Args:
          vid: (Cv, t) expert clip features (t = clip grid length).
          shallow_vid: (Cs, t) sidekick features on the same grid.
          texts: list of Q (Ct, l_q) token-feature arrays.
          text_cls: (Q, Cs) per-query CLS embeddings.
          fps / clip_size / clip_stride: the grid -> seconds mapping;
            duration defaults to the grid's full extent.
          ext_scores: optional (Q, t) external score streams.
        """
        vid = np.asarray(vid, np.float32)
        shallow_vid = np.asarray(shallow_vid, np.float32)
        texts = [np.asarray(tok, np.float32) for tok in texts]
        text_cls = np.asarray(text_cls, np.float32)
        if vid.ndim != 2 or shallow_vid.ndim != 2:
            raise ValueError("features are (channels, t)")
        t = vid.shape[1]
        if shallow_vid.shape[1] != t:
            raise ValueError(f"grid lengths differ: {vid.shape} {shallow_vid.shape}")
        q = len(texts)
        if text_cls.shape[0] != q:
            raise ValueError(f"{q} queries but text_cls is {text_cls.shape}")
        if duration is None:
            duration = t * clip_stride / fps
        sample = {
            "vid": vid, "shallow_vid": shallow_vid, "text": texts,
            "text_cls": text_cls, "fps": float(fps),
            "duration": float(duration), "clip_size": float(clip_size),
            "clip_stride": float(clip_stride),
            "clip_id": "serve", "text_id": list(range(q)),
        }
        if ext_scores is not None:
            sample["ext_scores"] = np.asarray(ext_scores, np.float32)
        return self._dec.video_items(sample)

    def ground(self, **request):
        """Ground Q queries against one video (see :meth:`_prepare` for the
        fields). Returns Q dicts {"segments": [[s, e], ...] in seconds,
        "scores": [...]}, at most nms.max_num_segs each, in SoftNMS emission
        order (non-increasing score)."""
        _, items = self._prepare(**request)
        results = []
        with self._turn():
            for item in items:
                results.extend(self._dec.decode_group([item])[0][0])
        with self._dec.timer.phase("serve.answer"):
            return _as_lists(results)


def _as_lists(results):
    return [{"segments": np.asarray(r["segments"]).tolist(),
             "scores": np.asarray(r["scores"]).tolist()} for r in results]


def service_from_logdir(logdir, ckpt="last", set_cfgs=None, device=None):
    """A GroundingService of an experiment directory under the eval CLI's
    config contract (frozen opt.yaml + defaults backfill + EMA weights of
    ``models/<ckpt>.pth``)."""
    cfg = config_from_logdir(logdir, ckpt, set_cfgs)
    return GroundingService(cfg, checkpoint=checkpoint_path(logdir, ckpt),
                            device=device)


def _load_field(req, name, required=True):
    """Inline nested lists or an .npy/.npz path."""
    if name in req:
        return np.asarray(req[name], np.float32)
    path = req.get(f"{name}_path")
    if path is not None:
        if name == "texts":
            with np.load(path) as z:
                return [np.asarray(z[k], np.float32) for k in sorted(z.files)]
        return np.load(path).astype(np.float32)
    if required:
        raise KeyError(f"request needs '{name}' or '{name}_path'")
    return None


def _request_kwargs(req):
    """One JSON request object -> :meth:`GroundingService.ground` kwargs."""
    if not isinstance(req, dict):
        raise TypeError("a request is a JSON object")
    texts = req.get("texts")
    if texts is not None:
        texts = [np.asarray(x, np.float32) for x in texts]
    else:
        texts = _load_field(req, "texts")
    kwargs = dict(vid=_load_field(req, "vid"),
                  shallow_vid=_load_field(req, "shallow_vid"),
                  texts=texts, text_cls=_load_field(req, "text_cls"))
    for k in ("fps", "duration", "clip_size", "clip_stride"):
        if k in req:
            kwargs[k] = float(req[k])
    ext = _load_field(req, "ext_scores", required=False)
    if ext is not None:
        kwargs["ext_scores"] = ext
    return kwargs


def make_handler(service):
    """The HTTP request handler class serving ``service``."""
    device = service.device
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device))

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet access log
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "device": str(device),
                                 "device_name": device_name,
                                 "n_devices": torch.cuda.device_count(),
                                 "phase_stats": service.stats()})
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path not in ("/ground", "/ground_batch"):
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/ground":
                    self._send(200, {"detections":
                                     service.ground(**_request_kwargs(req))})
                else:
                    batch = [_request_kwargs(r) for r in req["requests"]]
                    self._send(200, {"detections_batch":
                                     service.ground_many(batch)})
            except Exception as e:  # noqa: BLE001 -- reported to the client
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m decafnet_tpu_torch.serve",
        description="Serve an experiment's grounder over HTTP.")
    parser.add_argument("--name", required=True,
                        help="experiment directory containing opt.yaml")
    parser.add_argument("--ckpt", default="last")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8787)
    parser.add_argument("--warmup", nargs="*", default=(),
                        help="shape buckets to run once before serving, each "
                             "T,Q,L (e.g. --warmup 2304,8,24 512,1,8)")
    parser.add_argument("--set", dest="set_cfgs", nargs="*", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    service = service_from_logdir(args.name, args.ckpt, args.set_cfgs,
                                  device=args.device)
    print(f"device: {service.device}", flush=True)
    for spec in args.warmup:
        t, q, l = (int(x) for x in spec.split(","))
        print(f"warmup T={t} Q={q} L={l} ...", flush=True)
        service.warmup(t, q, l)

    server = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    print(f"serving {args.name} [{args.ckpt}] on "
          f"http://{args.host}:{args.port}  (POST /ground)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
