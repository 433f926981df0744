"""Online caption service: images in, styled captions out, on one card.

Port of ``CaptionService``, ``make_http_server`` and ``serve_background``
from ``captionax/decode/service.py`` (without ``mesh``).  Every concurrent
request goes through one
:class:`captionax_torch.decode.serving.MicroBatcher`: requests that arrive
while a batch is in flight coalesce into the next fixed-shape batch of
``batch_size`` uint8 images.  One dispatch per batch copies the images to
the card, then runs ``preprocess_images`` (resize to 224 and normalize),
the frozen ResNet encoder (:class:`captionax_torch.models.encoder.CNNEncoder`
in bf16, its stride-1 bottleneck chains on K4; or, with ``int8_encoder``,
the calibrated int8 trunk of ``encoder_cnn_int8``, its convs int8 x int8 ->
int32 library products) and the bank-indexed decode: each
request's row picks its style from a hypernet theta bank synthesized once,
when the service is built.  ``use_fused`` (default: on the card) decodes on
the K1 beam kernels, or K2 with ``decode="greedy"``; otherwise, as on the
CPU, on the plain ``beam_search`` / ``greedy`` with one theta per row.
"""

from __future__ import annotations

import functools
import json
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from captionax_torch.core.runtime import DeviceLike, resolve_device
from captionax_torch.data.transforms import preprocess_images
from captionax_torch.decode.search import beam_search, greedy
from captionax_torch.decode.serving import MicroBatcher, pack_beam_result, unpack_beam_result
from captionax_torch.eval.metrics import ids_to_text
from captionax_torch.interop import to_device
from captionax_torch.models.encoder import (
    CNNEncoder,
    encoder_cnn_int8,
    resnet_calibrate,
    resnet_quantize,
)
from captionax_torch.ops.decode_kernel import BeamDecoder, GreedyDecoder
from captionax_torch.train.steps import resolve_style_id, style_table, synthesize_theta_batched


def _int8_encoder(encoder_params, calibration, image_size: int, device: torch.device):
    """The int8 encoder as captionax's service builds it: calibrate the bf16
    forward on a preprocessed batch, widen every scale by 1.5 (activations
    past the calibrated max clip), quantize; -> images -> [B, 49, 2048]
    (a ``functools.partial`` of ``encoder_cnn_int8``: ``.args[0]`` is the
    quantized tree)."""
    params = to_device(encoder_params, device)
    if calibration is None:
        calibration = np.random.RandomState(0).randint(
            0, 256, (8, image_size, image_size, 3), dtype=np.uint8)
    with torch.no_grad():
        images = torch.as_tensor(np.asarray(calibration, np.uint8)).to(device)
        scales = resnet_calibrate(params, preprocess_images(images))
    scales["stages"] = [[{k: v * 1.5 for k, v in rec.items()} for rec in stage]
                        for stage in scales["stages"]]
    qparams = resnet_quantize(params, act_scales=scales)
    return functools.partial(encoder_cnn_int8, qparams)


class CaptionService:
    """Thread-safe styled-captioning service over one device.

    ``params`` is a hypernet model tree (``{"decoder", "hn", ...}``) or a
    plain attention-GRU decoder tree; ``styles`` names the rows of the theta
    bank (hypernet only — a plain GRU serves its single trained style under
    whatever name is passed first).  ``encoder_params`` is a ResNet tree
    (``resnet_init`` / ``from_torch_state_dict``), run in bf16.
    ``int8_encoder`` serves it quantized to int8 instead, with static
    activation scales calibrated when the service is built on
    ``int8_calibration`` (uint8 images [N, S, S, 3]; default: 8 images of
    random pixels from ``RandomState(0)``), times 1.5 as a margin.
    ``device=None`` means the card.
    """

    def __init__(
        self,
        params,
        encoder_params,
        vocab,
        styles: Sequence[str] = ("factual",),
        *,
        batch_size: int = 64,
        max_steps: int = 50,
        image_size: int = 224,
        use_fused: Optional[bool] = None,
        decode: str = "beam",
        int8_encoder: bool = False,
        int8_calibration=None,
        device: DeviceLike = None,
    ):
        if decode not in ("beam", "greedy"):
            raise ValueError(f"decode must be beam|greedy, got {decode!r}")
        dev = resolve_device(device)
        self.vocab = vocab
        self.styles = list(styles)
        self.decode = decode
        self.image_size = image_size
        self._sid = {s: i for i, s in enumerate(self.styles)}
        if use_fused is None:
            use_fused = dev.type == "cuda"

        params = to_device(params, dev)
        hyper = isinstance(params, dict) and "hn" in params
        decoder = params["decoder"] if hyper else params
        bank = None
        if hyper:
            ids = torch.tensor([resolve_style_id(params, vocab, s) for s in self.styles],
                               device=dev)
            with torch.no_grad():
                bank = synthesize_theta_batched(params, style_table(params)[ids])
        if int8_encoder:
            self.encoder = _int8_encoder(encoder_params, int8_calibration, image_size, dev)
        else:
            self.encoder = CNNEncoder(encoder_params, torch.bfloat16, dev)

        if use_fused:
            cls = GreedyDecoder if decode == "greedy" else BeamDecoder
            steps = {"max_len": max_steps} if decode == "greedy" else {"max_steps": max_steps}
            fused = cls(decoder, bank, device=dev, **steps)

            def decode_tokens(feats, rows):
                res = fused(feats, rows if bank is not None else None)
                return res if decode == "greedy" else pack_beam_result(res)
        else:
            def decode_tokens(feats, rows):
                # the plain decoders take one theta per row, not a bank
                theta = None if bank is None else {k: t[rows.long()] for k, t in bank.items()}
                if decode == "greedy":
                    return greedy(decoder, feats, max_len=max_steps, gru_params=theta,
                                  device=dev)
                return pack_beam_result(beam_search(decoder, feats, max_steps=max_steps,
                                                    gru_params=theta, device=dev))

        def dispatch(imgs: np.ndarray, rows: np.ndarray):
            with torch.no_grad():
                images = torch.from_numpy(imgs).to(dev)
                feats = self.encoder(preprocess_images(images))
                return decode_tokens(feats, torch.from_numpy(rows).to(dev))

        self._batcher = MicroBatcher(
            dispatch,
            batch_size=batch_size,
            feature_shape=(image_size, image_size, 3),
            styled=True,
            feature_dtype=np.uint8,
        )
        self._stats_lock = threading.Lock()
        self._lat_ms: list = []  # recent request latencies
        self._served = 0
        self._errors = 0

    def _record(self, dt_ms: float, error: bool = False):
        with self._stats_lock:
            if error:
                self._errors += 1
            else:
                self._served += 1
                self._lat_ms.append(dt_ms)
                if len(self._lat_ms) > 4096:
                    del self._lat_ms[:2048]

    def stats(self) -> dict:
        """Served/error counts, recent latency percentiles (ms) and the host
        process's resident memory."""
        with self._stats_lock:
            lat = np.asarray(self._lat_ms, np.float64)
            out = {"served": self._served, "errors": self._errors,
                   "styles": self.styles, "decode": self.decode}
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        out["rss_mb"] = round(int(line.split()[1]) / 1024, 1)
                        break
        except OSError:
            pass
        if lat.size:
            out["p50_ms"] = round(float(np.percentile(lat, 50)), 2)
            out["p95_ms"] = round(float(np.percentile(lat, 95)), 2)
        return out

    # -- request paths ----------------------------------------------------

    def submit_array(self, img: np.ndarray, style: str):
        """uint8 [H, W, 3] (already image_size x image_size) -> Future."""
        if style not in self._sid:
            raise KeyError(f"unknown style {style!r}; serving {self.styles}")
        want = (self.image_size, self.image_size, 3)
        if tuple(np.shape(img)) != want:
            raise ValueError(
                f"image must be shape {want}, got {np.shape(img)} "
                "(use caption_bytes for undecoded/unresized inputs)"
            )
        return self._batcher.submit(img, self._sid[style])

    def caption_array(self, img: np.ndarray, style: str) -> dict:
        t0 = time.perf_counter()
        try:
            out = self.submit_array(img, style).result()
        except Exception:
            self._record(0.0, error=True)
            raise
        self._record((time.perf_counter() - t0) * 1e3)
        if self.decode == "greedy":
            return {"caption": ids_to_text(out, self.vocab), "style": style}
        res = unpack_beam_result(out[None])
        return {
            "caption": ids_to_text(res.tokens[0], self.vocab),
            "score": float(res.scores[0]),
            "completed": bool(res.found[0]),
            "style": style,
        }

    def caption_bytes(self, data: bytes, style: str) -> dict:
        """Encoded JPEG/PNG bytes -> caption dict (native decode on the host)."""
        from captionax_torch.data.native_image import decode_resize

        img = decode_resize(data, (self.image_size, self.image_size))
        return self.caption_array(img, style)

    def close(self):
        self._batcher.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def make_http_server(service: CaptionService, host: str = "127.0.0.1",
                     port: int = 0, reuse_port: bool = False,
                     listen_fd: Optional[int] = None):
    """Build a ``ThreadingHTTPServer`` front end for ``service``.

    ``listen_fd`` adopts an already bound and listening socket inherited
    from a supervisor instead of binding: every worker generation then
    accepts from the same kernel accept queue, so a retiring worker that
    stops accepting strands no queued connection (SO_REUSEPORT, by
    contrast, gives each process its own accept queue, and Linux resets
    whatever sits in a queue when its socket closes).

    Endpoints:

    - ``GET /healthz`` -> ``{"status": "ok", "styles": [...]}``
    - ``GET /stats``   -> served/error counts + recent p50/p95 ms
    - ``POST /caption`` with an ``image/jpeg`` / ``image/png`` body
      (style via ``?style=...``), or an ``application/json`` body
      ``{"image_b64": ..., "style": ...}``.

    Returns the server; call ``serve_forever()`` (or run it on a thread)
    and ``shutdown()`` to stop.  Handler threads block in
    ``caption_bytes`` and the MicroBatcher coalesces them into shared
    dispatches.
    """
    import base64
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    class Server(ThreadingHTTPServer):
        # the stdlib's backlog of 5 resets bursts of more concurrent
        # connects before a handler thread runs
        request_queue_size = 128
        daemon_threads = True

        def server_bind(self):
            # SO_REUSEPORT lets a replacement worker bind the same port
            # while this one drains
            if reuse_port:
                import socket

                self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            super().server_bind()

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet by default
            pass

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {"status": "ok", "styles": service.styles,
                                 "decode": service.decode})
            elif path == "/stats":
                self._json(200, service.stats())
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/caption":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(n)
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("application/json"):
                    req = json.loads(raw)
                    data = base64.b64decode(req["image_b64"])
                    style = req.get("style", service.styles[0])
                else:
                    data = raw
                    q = parse_qs(url.query)
                    style = q.get("style", [service.styles[0]])[0]
                self._json(200, service.caption_bytes(data, style))
            except KeyError as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # undecodable image, bad json, ...
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    if listen_fd is not None:
        import socket

        srv = Server((host, port), Handler, bind_and_activate=False)
        srv.socket.close()  # discard the unbound constructor socket
        srv.socket = socket.socket(fileno=listen_fd)
        srv.server_address = srv.socket.getsockname()
        return srv
    return Server((host, port), Handler)


def serve_background(service: CaptionService, host: str = "127.0.0.1", port: int = 0):
    """Start the HTTP server on a daemon thread; returns (server, port)."""
    srv = make_http_server(service, host, port)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, srv.server_address[1]
