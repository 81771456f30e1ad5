"""HTTP tagging service.

    python -m audioset_convnext_inf_torch.cli.serve [--host 127.0.0.1] [--port 8787] \\
        [--checkpoint CKPT | --bundle AOT_DIR] [--batch-size 32] [--max-wait-ms 20] \\
        [--top-k 10] [--dtype bfloat16|float32] [--device cpu|cuda] [--mesh]

Runs on the card unless ``--device cpu`` is given. Endpoints (stdlib
``http.server``, one thread per connection; dynamic batching underneath,
``engine/service.py``):

  GET  /healthz   -> {"status": "ok", ...the service's counters}
  POST /tag       -> body: WAV bytes, raw float32 PCM, or raw int16 PCM at
                     32 kHz (Content-Type: audio/wav | application/octet-stream
                     | application/pcm-int16); a 16-bit mono 32-kHz WAV stays
                     int16 to the card (half the host-to-card bytes). Audio
                     longer than 10 s becomes 10-s windows that ride the
                     batcher and are max-reduced (engine/infer.py::tag_long_audio
                     semantics; the response gains "num_windows").
                     response: {"indexes": [...], "labels": [...], "probs": [...]}
  POST /embed     -> same bodies; response: {"embedding": [768 floats]}
                     (the clip padded or cropped to 10 s)

HTTP 429 when the request queue is full, 400 on any other error.
``--mesh`` serves each batch over every card of the machine
(``engine/service.py::ShardedModel``). ``--bundle`` serves from an AOT
bundle (``cli/export_serving.py``): no model code runs, the programs carry
the weights, ``--batch-size`` is clamped to the largest exported bucket, and
``--checkpoint`` and ``--dtype`` do not apply; the bundle serves on the
card unless ``--device cpu`` is given, and only on the device type it was
exported on.
/embed needs the bundle's "scene" programs. ``--bundle`` with ``--mesh`` is
an argument error: a bundle runs on one device.
"""

from __future__ import annotations

import argparse
import io
import json
from typing import Tuple

import numpy as np

from audioset_convnext_inf_torch.config import CLIP_SAMPLES


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8787)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--bundle", default=None,
                        help="serve from an AOT bundle directory (cli/export_serving.py); "
                             "no model code, no checkpoint")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--max-wait-ms", type=float, default=20.0)
    parser.add_argument("--top-k", type=int, default=10)
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                        help="bfloat16 serves the fast config (tanh GELU, the fused block kernel)")
    parser.add_argument("--device", default=None,
                        help="default: the card; 'cpu' to ask for the CPU")
    parser.add_argument("--mesh", action="store_true",
                        help="shard each batch over every card of the machine "
                             "(engine/service.py::ShardedModel); the batch size is not "
                             "rounded: the fused block kernel runs at any per-card batch")
    args = parser.parse_args(argv)
    if args.mesh and args.bundle:  # before any loading
        parser.error("--mesh shards the live model; a bundle runs on one device")
    if args.mesh and args.device is not None and args.device != "cuda":
        parser.error("--mesh serves over every card of the machine; --device names one")
    return args


def decode_audio(body: bytes, content_type: str) -> np.ndarray:
    """A request body as mono 32-kHz samples: int16 for a 16-bit mono 32-kHz
    WAV and for raw int16 PCM (the card decodes x / 32767), else float32."""
    if "wav" in content_type or body[:4] == b"RIFF":
        from scipy.io import wavfile

        from audioset_convnext_inf_torch.data.audio_io import normalize_pcm, resample_poly

        sr, data = wavfile.read(io.BytesIO(body))
        # The card's decode divides by 32767 (the reference's HDF5
        # convention), normalize_pcm by 32768 (soundfile's): a 3.1e-5 gain
        # difference between the two routes, as in the JAX package.
        if data.dtype == np.int16 and data.ndim == 1 and sr == 32000:
            return data
        x = normalize_pcm(data)  # int16/int32/uint8/float -> [-1, 1], mono
        if sr != 32000:
            x = resample_poly(x, sr, 32000)
        return x
    if "pcm-int16" in content_type:  # raw little-endian int16 PCM at 32 kHz
        return np.frombuffer(body, dtype="<i2")
    return np.frombuffer(body, dtype=np.float32)


def make_server(argv=None, model=None) -> Tuple[object, object]:
    """The HTTP server (not yet serving) and its started batching service.
    ``model`` replaces the one the flags would build (a ``models.ConvNeXt``
    on the flags' device; with ``--bundle``, an ``aot_export.BundleModel``).
    ``server.serve_forever()`` serves; to stop, call ``server.shutdown()``,
    ``server.server_close()`` and ``service.stop()``."""
    args = parse_args(argv)

    from audioset_convnext_inf_torch.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    import torch

    from audioset_convnext_inf_torch.engine.infer import sliding_windows
    from audioset_convnext_inf_torch.engine.service import (
        InferenceService,
        ServiceOverloaded,
        ShardedModel,
    )
    from audioset_convnext_inf_torch.labels import read_audioset_label_tags

    if model is None and args.bundle:
        from audioset_convnext_inf_torch.engine.aot_export import BundleModel, load_bundle

        model = BundleModel(load_bundle(args.bundle, device=args.device))
    elif model is None:
        from audioset_convnext_inf_torch import models
        from audioset_convnext_inf_torch.models.api import resolve_device

        device = resolve_device(args.device)
        compute_dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
        if args.checkpoint:
            model = models.ConvNeXt.from_pretrained(args.checkpoint, compute_dtype=compute_dtype,
                                                    device=device)
        else:
            model = models.convnext_tiny(drop_path_rate=0.0, compute_dtype=compute_dtype,
                                         device=device)
            print("WARNING: no checkpoint given - serving random weights")
    max_batch = getattr(model, "max_batch", None)
    if max_batch is not None and args.batch_size > max_batch:
        print(f"batch-size {args.batch_size} > the bundle's largest bucket; using {max_batch}")
        args.batch_size = max_batch
    if args.mesh:
        model = ShardedModel(model)  # every card; raises without one
        print(f"mesh serving over {len(model.replicas.devices)} card(s)")
    service = InferenceService(model, batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
                               pcm_int16=True).start()
    labels = read_audioset_label_tags()

    def tag(wav: np.ndarray) -> dict:
        extra = {}
        if len(wav) > CLIP_SAMPLES:
            # long audio: 10-s windows submitted as clips (the batcher fills
            # batches with them), max-reduced. int16 windows stay int16. They
            # go in chunks of max_queued // 2, each resolved before the next,
            # so audio longer than max_queued windows does not trip the
            # backpressure of an idle service.
            windows, n = sliding_windows(wav)
            chunk = max(1, service.max_queued // 2)
            rows = []
            for s in range(0, len(windows), chunk):
                futs = [service.submit(w) for w in windows[s: s + chunk]]
                rows += [f.result(timeout=600)["clipwise_output"] for f in futs]
            probs = np.stack(rows)[:n].max(axis=0)
            extra["num_windows"] = int(n)
        else:
            probs = service.tag(wav)["clipwise_output"]
        top = np.argsort(probs)[::-1][: args.top_k]
        return {"indexes": [int(i) for i in top],
                "labels": [labels.ix_to_lb[int(i)] for i in top],
                "probs": [float(probs[i]) for i in top], **extra}

    def embed(wav: np.ndarray) -> dict:
        clip = np.zeros(CLIP_SAMPLES, wav.dtype)  # a request's buffer is read-only
        clip[:len(wav)] = wav[:CLIP_SAMPLES]
        with service.model_lock:  # engine/service.py: model calls outside the batcher
            emb = model.forward_scene_embeddings(clip[None, :])
        return {"embedding": emb[0].float().cpu().tolist()}

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj) -> None:
            payload = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", **service.counters()})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                wav = decode_audio(self.rfile.read(length), self.headers.get("Content-Type", ""))
                if self.path == "/tag":
                    self._send(200, tag(wav))
                elif self.path == "/embed":
                    self._send(200, embed(wav))
                else:
                    self._send(404, {"error": "unknown path"})
            except ServiceOverloaded:
                self._send(429, {"error": "overloaded, retry later"})
            except Exception as e:  # noqa: BLE001
                self._send(400, {"error": repr(e)})

        def log_message(self, fmt, *a):  # quiet
            pass

    class Server(ThreadingHTTPServer):
        daemon_threads = True
        # socketserver listens with a backlog of 5: more clients connecting
        # at once than that lose their SYN and retry a second later
        request_queue_size = 128

    try:
        server = Server((args.host, args.port), Handler)
    except Exception:
        service.stop()
        raise
    print(f"serving on http://{args.host}:{server.server_address[1]} (batch {args.batch_size})")
    return server, service


def main(argv=None) -> int:
    server, service = make_server(argv)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
