"""Batched segmentation serving: micro-batching queue + stdlib HTTP front
(counterpart of ``dupl_tpu/engine/serve.py``, same HTTP contract).

``POST /v1/segment`` takes a PNG/JPEG (or ``application/x-npy`` HxWx3 uint8)
body and answers an indexed-palette PNG label map at the image's native
resolution, or the raw uint8 map as ``.npy`` under ``Accept:
application/x-npy``.  ``GET /healthz`` returns the session metadata, ``GET
/metrics`` request and dispatch counters.  Requests are decoded on handler
threads and micro-batched up to the session's batch size: one device
program in flight, arrivals within ``max_delay_s`` ride the same dispatch.
A session serves a live model (``from_weights``, ``from_model``) or a sealed
``.duplsrv`` program (``from_artifact``).
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from dupl_tpu_torch.utils import colormap

# Reject request bodies above this size (a 448^2 RGB float64 .npy is ~4.8 MB).
MAX_BODY_BYTES = 64 * 1024 * 1024


def _set_result(fut: Future, value) -> None:
    """Resolve ``fut`` unless ``submit()`` or ``close()`` failed it first
    (whoever sets first wins; the loser must not kill the worker)."""
    try:
        fut.set_result(value)
    except InvalidStateError:
        pass


def _set_exception(fut: Future, exc: BaseException) -> None:
    try:
        fut.set_exception(exc)
    except InvalidStateError:
        pass


class InferenceSession:
    """Wraps the serving program behind a plain
    ``list[np.ndarray HxWx3 uint8] -> list[np.ndarray HxW uint8]`` call.

    Host-side contract: per-image PIL bilinear resize to the program's
    square crop, zero-pad the batch to the session batch size, nearest-resize
    each label map back to its native resolution."""

    def __init__(self, run_batch: Callable[[np.ndarray], np.ndarray], *,
                 batch_size: int, crop_size: int, num_classes: int,
                 meta: Optional[dict] = None):
        self._run = run_batch
        self.batch_size = batch_size
        self.crop_size = crop_size
        self.num_classes = num_classes
        self.meta = dict(meta or {})

    # -- constructors ----------------------------------------------------------
    @classmethod
    def from_artifact(cls, path: str, *, device) -> "InferenceSession":
        """Serve a sealed segmentation program (a ``.duplsrv`` file of
        ``engine/export.py``) on ``device``, which must be the device it was
        sealed for: a program is never moved."""
        from dupl_tpu_torch.engine.export import load_artifact, read_meta

        meta = read_meta(path)
        if meta.get("kind", "segmentation") == "pseudo_labeler":
            raise ValueError(
                f"{path} is a pseudo_labeler artifact ((images, cls_label, "
                "img_box) signature); the segmentation server cannot serve "
                "it — export with engine.export.export_serving instead")
        if not meta.get("bake_params", True):
            raise ValueError(
                f"{path} was exported with bake_params=False (a (params, "
                "images) signature); call its module with the weights, or "
                "re-export with the weights baked in")
        device = torch.device(device)
        sealed_for = meta["platforms"][0]
        if device.type != sealed_for:
            raise ValueError(
                f"{path} was sealed for {sealed_for}, asked to serve on "
                f"{device.type}: re-export it with tools/export_model_torch.py "
                f"--device {device.type}")
        n_dev = int(meta.get("num_devices", 1))
        if device.type == "cuda" and n_dev > torch.cuda.device_count():
            raise ValueError(
                f"{path} was exported for {n_dev} devices (mesh="
                f"{meta.get('mesh')}); this host has only "
                f"{torch.cuda.device_count()} — re-export for this topology")
        program = load_artifact(path)[0].module()

        @torch.inference_mode()
        def run(imgs: np.ndarray) -> np.ndarray:
            return program(torch.from_numpy(imgs).to(device)).cpu().numpy()

        meta = {**meta, "device": str(device)}
        return cls(run, batch_size=meta["batch_size"],
                   crop_size=meta["crop_size"],
                   num_classes=meta["num_classes"], meta=meta)

    @classmethod
    def from_model(cls, cfg, model, *, device, batch_size: int = 8,
                   scales: Sequence[float] = (1.0, 1.5, 1.25),
                   merge: str = "max", branch="ensemble",
                   crf: bool = True) -> "InferenceSession":
        """Serve a ``DualStudent`` (moved to ``device``)."""
        from dupl_tpu_torch.engine.export import make_serving_fn

        device = torch.device(device)
        model = model.to(device).eval()
        fn = make_serving_fn(cfg, model, scales=scales, merge=merge,
                             branch=branch, crf=crf)

        def run(imgs: np.ndarray) -> np.ndarray:
            return fn(torch.from_numpy(imgs).to(device)).cpu().numpy()

        meta = {"branch": branch, "crf": crf, "scales": list(scales),
                "merge": merge, "live": True, "device": str(device)}
        return cls(run, batch_size=batch_size, crop_size=cfg.data.crop_size,
                   num_classes=cfg.num_classes, meta=meta)

    @classmethod
    def from_weights(cls, cfg, weights_path: str, *, device,
                     batch_size: int = 8,
                     scales: Sequence[float] = (1.0, 1.5, 1.25),
                     merge: str = "max", branch="ensemble",
                     crf: bool = True) -> "InferenceSession":
        """Live mode from a weights ``.npz`` written by the JAX package's
        ``checkpoint.export_weights``."""
        from dupl_tpu_torch.models.convert import load_weights
        from dupl_tpu_torch.models.network import DualStudent

        model = DualStudent(cfg.model)
        model.load_state_dict(load_weights(weights_path))
        return cls.from_model(cfg, model, device=device,
                              batch_size=batch_size, scales=scales,
                              merge=merge, branch=branch, crf=crf)

    # -- inference -------------------------------------------------------------
    def predict(self, images: List[np.ndarray]) -> List[np.ndarray]:
        if len(images) > self.batch_size:
            out: List[np.ndarray] = []
            for lo in range(0, len(images), self.batch_size):
                out.extend(self.predict(images[lo:lo + self.batch_size]))
            return out
        from PIL import Image

        s = self.crop_size
        batch = np.zeros((self.batch_size, s, s, 3), np.uint8)
        for i, img in enumerate(images):
            if img.ndim != 3 or img.shape[-1] != 3 or img.dtype != np.uint8:
                raise ValueError(
                    f"image {i}: want HxWx3 uint8, got {img.shape} {img.dtype}")
            batch[i] = np.asarray(
                Image.fromarray(img).resize((s, s), Image.BILINEAR))
        labels = self._run(batch)
        out = []
        for i, img in enumerate(images):
            h, w = img.shape[:2]
            lab = Image.fromarray(labels[i]).resize((w, h), Image.NEAREST)
            out.append(np.asarray(lab, np.uint8))
        return out


class Batcher:
    """Bounded-delay micro-batching: requests enqueue individually; one worker
    drains up to ``session.batch_size`` of them per device dispatch, waiting
    at most ``max_delay_s`` after the first arrival for co-riders."""

    def __init__(self, session: InferenceSession, max_delay_s: float = 0.01):
        self.session = session
        self.max_delay_s = max_delay_s
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()
        self._stats = {"dispatches": 0, "samples": 0, "failed_dispatches": 0,
                       "dispatch_seconds": 0.0}
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def stats(self) -> dict:
        with self._stats_lock:
            s = dict(self._stats)
        d = max(1, s["dispatches"])
        s["avg_batch"] = round(s["samples"] / d, 3)
        s["avg_dispatch_ms"] = round(1e3 * s["dispatch_seconds"] / d, 3)
        return s

    def submit(self, image: np.ndarray) -> "Future[np.ndarray]":
        fut: "Future[np.ndarray]" = Future()
        if self._stop.is_set():
            fut.set_exception(RuntimeError("batcher closed"))
            return fut
        self._q.put((image, fut))
        if self._stop.is_set():
            # close() may have drained the queue between the check and the
            # put; nobody will process the item now
            _set_exception(fut, RuntimeError("batcher closed"))
        return fut

    def close(self) -> None:
        self._stop.set()
        self._q.put(None)
        self._worker.join(timeout=5)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                _set_exception(item[1], RuntimeError("batcher closed"))
        # a worker that outlived the join (wedged in inference) must find a
        # sentinel when it comes back, not block on the drained queue
        self._q.put(None)

    def _loop(self) -> None:
        while not self._stop.is_set():
            first = self._q.get()
            if first is None:
                continue
            items = [first]
            deadline = time.monotonic() + self.max_delay_s
            while len(items) < self.session.batch_size:
                try:
                    nxt = self._q.get(
                        timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    break
                if nxt is None:
                    break
                items.append(nxt)
            t0 = time.monotonic()
            try:
                preds = self.session.predict([im for im, _ in items])
                err = None
            except Exception as exc:  # the worker must outlive a bad dispatch
                preds, err = None, exc

            # account the dispatch before resolving futures: a client whose
            # response just completed must see its dispatch in /metrics
            with self._stats_lock:
                self._stats["dispatches"] += 1
                self._stats["samples"] += len(items)
                self._stats["dispatch_seconds"] += time.monotonic() - t0
                if err is not None:
                    self._stats["failed_dispatches"] += 1

            if err is None:
                for (_, fut), pred in zip(items, preds):
                    _set_result(fut, pred)
            else:
                for _, fut in items:
                    _set_exception(fut, err)


def _decode_image(body: bytes, content_type: str) -> np.ndarray:
    if content_type == "application/x-npy":
        arr = np.load(io.BytesIO(body), allow_pickle=False)
        # strict: a silent cast would truncate float [0,1] images to zeros
        if arr.dtype != np.uint8:
            raise ValueError(
                f"x-npy body must be uint8, got {arr.dtype} — scale to "
                "[0,255] and cast client-side")
        img = arr
    else:
        from PIL import Image

        img = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
    # validate before the request joins a micro-batch: a malformed image
    # failing inside the batched predict() would fail every co-rider
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"want HxWx3 RGB, got shape {img.shape}")
    return img


def _encode_png(label: np.ndarray) -> bytes:
    from PIL import Image

    img = Image.fromarray(label.astype(np.uint8), mode="P")
    img.putpalette(colormap.voc_colormap().reshape(-1).tolist())
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


class _Server(ThreadingHTTPServer):
    # socketserver's default listen backlog of 5 holds 6 pending connections;
    # the SYNs of further concurrent clients are dropped and retried after
    # the kernel's 1 s initial retransmit timeout
    request_queue_size = 128


def make_http_server(batcher: Batcher, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
    """HTTP front over ``batcher``.  Returns the (not yet serving)
    ThreadingHTTPServer; callers drive ``serve_forever`` on their own
    thread."""
    session = batcher.session
    req_lock = threading.Lock()
    req_stats = {"requests": 0, "responses_2xx": 0, "responses_4xx": 0,
                 "responses_5xx": 0}

    def _count(code: int) -> None:
        with req_lock:
            req_stats["requests"] += 1
            bucket = ("responses_2xx" if code < 400 else
                      "responses_4xx" if code < 500 else "responses_5xx")
            req_stats[bucket] += 1

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # request logs belong to the deployment
            pass

        def _json(self, code: int, obj: dict) -> None:
            _count(code)
            blob = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok",
                                 "batch_size": session.batch_size,
                                 "crop_size": session.crop_size,
                                 "num_classes": session.num_classes,
                                 **session.meta})
            elif self.path == "/metrics":
                with req_lock:
                    merged = dict(req_stats)
                self._json(200, {**merged, **batcher.stats()})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/v1/segment":
                self._json(404, {"error": "unknown path"})
                return
            # bad body -> 400; inference failure -> 500; timeout -> 504
            try:
                n = int(self.headers.get("Content-Length", "0"))
                if n < 0:
                    # read(-1) would buffer until EOF, bypassing the cap
                    self._json(400, {"error": f"invalid Content-Length {n}"})
                    return
                if n > MAX_BODY_BYTES:
                    self._json(413, {"error": f"body {n} bytes exceeds "
                                              f"limit {MAX_BODY_BYTES}"})
                    return
                img = _decode_image(self.rfile.read(n),
                                    self.headers.get("Content-Type", ""))
            except Exception as exc:  # any undecodable body is the client's
                self._json(400, {"error": f"{type(exc).__name__}: {exc}"})
                return
            try:
                pred = batcher.submit(img).result(timeout=300)
            except (TimeoutError, FuturesTimeoutError) as exc:
                self._json(504, {"error": f"inference timed out: {exc}"})
                return
            except Exception as exc:  # reported to the client, server runs on
                # ValueError from predict() is a violated input contract
                code = 400 if isinstance(exc, ValueError) else 500
                self._json(code, {"error": f"{type(exc).__name__}: {exc}"})
                return
            try:
                if self.headers.get("Accept") == "application/x-npy":
                    buf = io.BytesIO()
                    np.save(buf, pred)
                    blob, ctype = buf.getvalue(), "application/x-npy"
                else:
                    blob, ctype = _encode_png(pred), "image/png"
            except Exception as exc:  # an encode failure is still counted
                self._json(500, {"error": f"encode: {type(exc).__name__}: "
                                          f"{exc}"})
                return
            _count(200)
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

    return _Server((host, port), Handler)
