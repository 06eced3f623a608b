"""HTTP serving with micro-batching (``fastspeech2_tpu/infer/server.py``).

Requests queue on arrival and a dispatch thread drains them in micro-batches:
concurrent requests share one padded forward pass, so the card runs
tensor-core-shaped batches instead of B=1 calls.

API (JSON over HTTP, stdlib-only):

    GET  /healthz             -> {"status": "ok", ...}
    POST /synthesize          body: {"text": "..."} or
                                    {"phonemes": "HH AH0 L OW1 ..."}
                              optional: "alpha": float, "format": "mel"|"wav"
      format=mel (default): {"mel": [[...80 floats...] x L], "frames": L, ...}
      format=wav: audio/wav bytes, from the synthesizer's attached vocoder
        or the ``vocoder=`` callable given to ``serve``; HTTP 501 without
        either (the JAX package falls back to Griffin-Lim there, which needs
        ``fastspeech2_tpu/audio/``, not ported yet)
    POST /stream              body: {"text": "..."} (optional "alpha")
      chunked streaming WAV: the paragraph is split into sentences, ALL
      sentences are submitted
      to the batcher up front (so they share micro-batches), and each
      sentence's PCM streams out the moment it is synthesized -- first audio
      after one sentence's latency instead of the whole paragraph's.

Run: build a ``Synthesizer`` (``infer/synthesize.py``), attach a vocoder and
call ``serve(synth, cfg, port=8000)``; the README's port section has the
snippet.

Both batcher threads enqueue CUDA work on the default stream: device work
of two in-flight batches serialises, host work (padding, the demand read, the
final copies, response writing) overlaps, and no tensor crosses streams.
"""

from __future__ import annotations

import io
import json
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

log = logging.getLogger("fastspeech2_tpu_torch.serve")


@dataclass
class _Request:
    tokens: np.ndarray
    alpha: float
    done: threading.Event = field(default_factory=threading.Event)
    mel: Optional[np.ndarray] = None
    wav: Optional[np.ndarray] = None  # set when the batcher runs fused tts
    error: Optional[str] = None
    # frame buffer hit the synthesizer's max_frames ceiling: the audio is
    # capped (Synthesizer._truncated); surfaced in the response
    truncated: bool = False


class Batcher:
    """Collects concurrent requests into one padded forward pass, with
    double-buffered dispatch.

    The first request of a batch waits up to ``max_wait_ms`` for company;
    whatever arrived by then (capped at ``max_batch``) runs together. Alpha
    (speed control) is a per-row vector, so requests with different speeds
    share one batch.

    Two threads pipeline the device: the dispatch thread enqueues
    micro-batch k+1's first device work (Synthesizer.*_async returns without
    waiting) while the delivery thread blocks on batch k's device->host
    copies and hands results to the waiting handlers. A synchronous loop
    would leave the card idle for those copies between batches. ``_slots``
    bounds dispatched-but-undelivered batches to TWO (one executing + one
    delivering): the dispatch thread takes a slot BEFORE enqueueing the device
    call and the delivery thread returns it after the transfer, so device
    memory holds at most two micro-batches of output buffers -- a third
    would add memory without throughput (if delivery is slower than
    compute, the pipeline is delivery-bound either way).
    """

    def __init__(self, synthesizer, max_batch: int = 16,
                 max_wait_ms: float = 5.0):
        self.synth = synthesizer
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.q: "queue.Queue[_Request]" = queue.Queue()
        self._pending: "queue.Queue" = queue.Queue(maxsize=1)
        self._slots = threading.Semaphore(2)
        self.stats = {"requests": 0, "batches": 0, "frames": 0, "truncated": 0}
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.delivery_thread = threading.Thread(target=self._deliver_loop,
                                                daemon=True)
        self.thread.start()
        self.delivery_thread.start()

    def submit(self, tokens: np.ndarray, alpha: float = 1.0) -> _Request:
        req = _Request(tokens=np.asarray(tokens, np.int64), alpha=alpha)
        self.q.put(req)
        return req

    def close(self):
        self._stop.set()
        self.q.put(None)  # unblock the dispatch thread
        self.thread.join(timeout=5)
        # always inject a delivery sentinel: the dispatch thread's own
        # put_nowait sentinel may have been dropped on a full queue, and a
        # wedged dispatch never sends one. A duplicate None is harmless
        # (delivery exits on the first); the bounded put never hangs close()
        # on a wedged delivery thread.
        try:
            self._pending.put(None, timeout=5)
        except queue.Full:
            pass
        self.delivery_thread.join(timeout=5)

    def _take_batch(self) -> List[_Request]:
        first = self.q.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_ms / 1000.0
        while len(batch) < self.max_batch:
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                break
            try:
                nxt = self.q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _loop(self):
        """Dispatch thread: pad + enqueue the device call, hand the finisher
        to the delivery thread, immediately take the next batch."""
        while not self._stop.is_set():
            # take a dispatch slot BEFORE collecting the batch: while both
            # slots are busy (delivery-bound pipeline) arriving requests
            # keep pooling in q and join ONE fuller micro-batch instead of
            # fragmenting across two under-filled dispatches; it also keeps
            # dispatched-but-undelivered batches bounded at two (docstring).
            # Stay responsive to close() while waiting.
            got_slot = False
            while not got_slot and not self._stop.is_set():
                got_slot = self._slots.acquire(timeout=0.5)
            if not got_slot:
                break
            batch = self._take_batch()
            if not batch:
                self._slots.release()
                continue
            fused = bool(getattr(self.synth, "has_vocoder", False))
            try:
                # Fused tts when the synthesizer has a vocoder attached: one
                # device call produces mel AND wav for the whole micro-batch
                # (no per-request vocoder dispatches, no mel re-upload).
                if fused:
                    finish = self.synth.wav_from_token_batch_async(
                        [r.tokens for r in batch],
                        alpha=[r.alpha for r in batch])
                else:
                    finish = self.synth.mel_from_token_batch_async(
                        [r.tokens for r in batch],
                        alpha=[r.alpha for r in batch])
            except Exception as e:  # dispatch-time failure (e.g. bad alpha)
                log.exception("batch dispatch failed")
                self._slots.release()
                for r in batch:
                    r.error = str(e)
                    r.done.set()
                continue
            # bounded put that stays responsive to close(): if the server
            # shuts down while delivery is gone/wedged, fail the batch's
            # requests instead of orphaning them (their handlers would
            # otherwise wait out the full SYNTH_TIMEOUT_S)
            while True:
                try:
                    self._pending.put((batch, finish, fused), timeout=0.5)
                    break
                except queue.Full:
                    if self._stop.is_set():
                        self._slots.release()
                        for r in batch:
                            r.error = "server shutting down"
                            r.done.set()
                        break
        try:
            self._pending.put_nowait(None)  # delivery drains, then exits
        except queue.Full:
            pass  # close() injects its own sentinel when delivery lags

    def _deliver_loop(self):
        """Delivery thread: block on batch k's device->host transfer and
        complete its requests while the dispatch thread runs batch k+1."""
        while True:
            item = self._pending.get()
            if item is None:
                return
            batch, finish, fused = item
            try:
                self._deliver_one(batch, finish, fused)
            finally:
                self._slots.release()  # batch's device buffers are done

    def _deliver_one(self, batch, finish, fused):
        """Finish one batch's device->host transfer and complete its
        requests; exceptions surface per-request (serving continues)."""
        try:
            if fused:
                mels, wavs, wav_lens, trunc = finish()
                hop = self.synth.hop_length
                out_lens = wav_lens // hop
                for r, mel, wav, wn, tr in zip(batch, mels, wavs,
                                               wav_lens, trunc):
                    r.mel = mel[: int(wn) // hop]
                    r.wav = wav[: int(wn)]
                    r.truncated = bool(tr)
            else:
                mels, out_lens, trunc = finish()
                for r, mel, n, tr in zip(batch, mels, out_lens, trunc):
                    r.mel = mel[: int(n)]
                    r.truncated = bool(tr)
            self.stats["truncated"] += int(np.sum(trunc))
            self.stats["requests"] += len(batch)
            self.stats["batches"] += 1
            self.stats["frames"] += int(np.sum(out_lens))
        except Exception as e:  # surface per-request, keep serving
            log.exception("batch failed")
            for r in batch:
                r.error = str(e)
        for r in batch:
            r.done.set()


def make_handler(batcher: Batcher, cfg, vocoder=None):
    from fastspeech2_tpu_torch.infer.synthesize import pcm16
    from fastspeech2_tpu_torch.text import phonemes_to_sequence
    from fastspeech2_tpu_torch.text.g2p import preprocess_text, process_paragraph

    can_wav = vocoder is not None or bool(getattr(batcher.synth, "has_vocoder",
                                                  False))
    no_vocoder = ("wav output needs a vocoder: attach one to the synthesizer "
                  "or pass vocoder= to serve (the Griffin-Lim fallback, "
                  "fastspeech2_tpu/audio/griffin_lim.py, is not ported yet)")

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 for Transfer-Encoding: chunked on /stream; every other
        # response carries an explicit Content-Length, so keep-alive is safe
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.debug(fmt, *args)

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", **batcher.stats})
            else:
                self._json(404, {"error": "unknown path"})

        MAX_BODY = 1 << 20  # 1 MiB of JSON text is already absurd for TTS
        SYNTH_TIMEOUT_S = 600.0  # batcher-death guard, not a latency bound
        MAX_STREAM_SENTENCES = 256  # one /stream can't flood the batcher

        def _parse_payload(self):
            """Validated (alpha, fmt, phonemes, text) or None after a 4xx."""
            try:
                n = int(self.headers.get("Content-Length", 0))
            except (ValueError, TypeError):
                # body length unknowable -> body unreadable: reply and drop
                # the connection so leftovers can't masquerade as the next
                # keep-alive request
                self.close_connection = True
                self._json(400, {"error": "bad Content-Length"})
                return None
            if n < 0:
                # rfile.read(-1) would block until EOF, pinning the handler
                # thread; same unreadable-body treatment as unparseable
                self.close_connection = True
                self._json(400, {"error": "bad Content-Length"})
                return None
            if n > self.MAX_BODY:
                # drain a bounded amount so the client's send() completes and
                # it can read the 413 (an RST from unread data would eat the
                # reply); past the drain cap, close and let it reset
                self.close_connection = True
                drained = 0
                while drained < min(n, 16 << 20):
                    chunk = self.rfile.read(min(65536, n - drained))
                    if not chunk:
                        break
                    drained += len(chunk)
                self._json(413, {"error": f"body over {self.MAX_BODY} bytes"})
                return None
            try:
                payload = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("body must be a JSON object")
                alpha = float(payload.get("alpha", 1.0))
                # reject here: a bad alpha inside a shared micro-batch would
                # otherwise fail every request batched with it
                if not (0.0 < alpha <= 10.0):
                    raise ValueError(f"alpha must be in (0, 10], got {alpha}")
                fmt = payload.get("format", "mel")
                if fmt not in ("mel", "wav"):
                    raise ValueError(f"format must be mel|wav, got {fmt!r}")
                phonemes = payload.get("phonemes")
                text = payload.get("text")
                if not phonemes and not text:
                    raise ValueError("body needs 'text' or 'phonemes'")
                if phonemes is not None and not isinstance(phonemes, str):
                    raise ValueError("'phonemes' must be a string")
                if text is not None and not isinstance(text, str):
                    raise ValueError("'text' must be a string")
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                # TypeError: non-numeric alpha (null, [1]) -- still a 400,
                # not a dropped connection. The try spans only payload
                # parsing/validation: a frontend bug must be a 500, not be
                # misreported as a client error.
                self._json(400, {"error": str(e)})
                return None
            return alpha, fmt, phonemes, text

        def _req_pcm(self, req) -> np.ndarray:
            """Finished request -> int16 PCM (fused-path wav, else the
            vocoder callable on the mel)."""
            if req.wav is not None:  # fused path: already int16 PCM
                return req.wav.astype("<i2", copy=False)
            return pcm16(np.asarray(vocoder(req.mel))).astype("<i2", copy=False)

        def do_POST(self):
            if self.path == "/stream":
                self._stream()
                return
            if self.path != "/synthesize":
                # the POST body was never read: close so it can't be parsed
                # as the next keep-alive request
                self.close_connection = True
                self._json(404, {"error": "unknown path"})
                return
            parsed = self._parse_payload()
            if parsed is None:
                return
            alpha, fmt, phonemes, text = parsed
            if fmt == "wav" and not can_wav:
                self._json(501, {"error": no_vocoder})
                return

            if phonemes:
                try:
                    tokens = np.asarray(phonemes_to_sequence(phonemes),
                                        np.int64)
                except Exception as e:  # unknown symbols = client input error
                    self._json(400, {"error": f"bad phonemes: {e}"})
                    return
            else:
                try:  # any string should g2p: failures here are server bugs
                    tokens = np.asarray(
                        phonemes_to_sequence(preprocess_text(text)), np.int64)
                except Exception:
                    log.exception("text frontend failed on %r", text[:200])
                    self._json(500, {"error": "internal frontend error"})
                    return
            if tokens.size == 0:
                self._json(400, {"error": "input produced no phonemes"})
                return

            t0 = time.perf_counter()
            req = batcher.submit(tokens, alpha)
            if not req.done.wait(self.SYNTH_TIMEOUT_S):
                # a dead/wedged batcher must not pin handler threads forever
                self._json(504, {"error": "synthesis timed out"})
                return
            if req.error is not None:
                self._json(500, {"error": req.error})
                return
            latency = time.perf_counter() - t0
            if fmt == "mel":
                obj = {
                    "mel": np.asarray(req.mel, np.float32).tolist(),
                    "frames": int(req.mel.shape[0]),
                    "latency_s": round(latency, 4),
                }
                if req.truncated:  # frame buffer hit max_frames: audio capped
                    obj["truncated"] = True
                self._json(200, obj)
            else:
                body = _wav_bytes(self._req_pcm(req), cfg.audio.sample_rate)
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(body)))
                if req.truncated:
                    self.send_header("X-Truncated", "1")
                self.end_headers()
                self.wfile.write(body)

        def _chunk(self, data: bytes):
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

        def _stream(self):
            parsed = self._parse_payload()
            if parsed is None:
                return
            alpha, _, phonemes, text = parsed
            if not can_wav:
                self._json(501, {"error": no_vocoder})
                return
            # same precedence as /synthesize: explicit phonemes win over text
            if phonemes:
                try:  # one pre-tokenized "sentence"; bad symbols = client 400
                    token_seqs = [np.asarray(phonemes_to_sequence(phonemes),
                                             np.int64)]
                except Exception as e:
                    self._json(400, {"error": f"bad phonemes: {e}"})
                    return
            else:
                try:  # any string should g2p: failures here are server bugs
                    sent_strs = [preprocess_text(s)
                                 for s in process_paragraph(text) if s.strip()]
                    token_seqs = [
                        np.asarray(phonemes_to_sequence(p), np.int64)
                        for p in sent_strs if p]
                except Exception:
                    log.exception("text frontend failed on %r", text[:200])
                    self._json(500, {"error": "internal frontend error"})
                    return
            token_seqs = [t for t in token_seqs if t.size]
            if not token_seqs:
                self._json(400, {"error": "input produced no phonemes"})
                return
            if len(token_seqs) > self.MAX_STREAM_SENTENCES:
                # bounds what one request can enqueue on the shared batcher
                self._json(400, {"error": (
                    f"over {self.MAX_STREAM_SENTENCES} sentences in one "
                    "stream; split the request")})
                return

            # submit every sentence BEFORE streaming: they coalesce into
            # shared micro-batches while earlier sentences are being written
            reqs = [batcher.submit(t, alpha) for t in token_seqs]
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self._chunk(_wav_stream_header(cfg.audio.sample_rate))
            for req in reqs:
                if not req.done.wait(self.SYNTH_TIMEOUT_S):
                    log.error("stream aborted: synthesis timed out")
                    self.close_connection = True
                    return
                if req.error is not None:
                    # status line is already sent: abort the stream so the
                    # client sees a truncated (invalid) chunked body, not
                    # silently missing sentences
                    log.error("stream aborted: %s", req.error)
                    self.close_connection = True
                    return
                if req.truncated:  # status line already sent: log + stats
                    log.warning("stream sentence truncated at the frame cap")
                self._chunk(self._req_pcm(req).tobytes())
            self._chunk(b"")  # terminating zero-length chunk

    return Handler


def _wav_stream_header(sample_rate: int) -> bytes:
    """44-byte mono 16-bit PCM WAV header with unknown (0xFFFFFFFF)
    RIFF/data sizes -- the convention players/ffmpeg accept for live WAV
    streams whose final length is not known when the header is sent."""
    import struct

    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                                    sample_rate * 2, 2, 16)
            + b"data" + struct.pack("<I", 0xFFFFFFFF))


def _wav_bytes(pcm16: np.ndarray, sample_rate: int) -> bytes:
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm16.tobytes())
    return buf.getvalue()


class _HTTPServer(ThreadingHTTPServer):
    # the default listen backlog of 5 overflows when a burst of clients
    # connects at once: a dropped SYN is retried after one second
    request_queue_size = 128


def serve(synthesizer, cfg, host: str = "0.0.0.0", port: int = 8000,
          max_batch: int = 16, max_wait_ms: float = 5.0, vocoder=None,
          ready_event: Optional[threading.Event] = None,
          stop_event: Optional[threading.Event] = None):
    """Blocking server loop. ready_event fires once bound; setting
    stop_event (from another thread) shuts the server down, after which the
    batcher is closed and the socket released."""
    batcher = Batcher(synthesizer, max_batch=max_batch, max_wait_ms=max_wait_ms)
    httpd = _HTTPServer((host, port), make_handler(batcher, cfg, vocoder))
    if stop_event is not None:
        threading.Thread(target=lambda: (stop_event.wait(), httpd.shutdown()),
                         daemon=True).start()
    if ready_event is not None:
        ready_event.set()
    log.info("serving on %s:%d (max_batch=%d, max_wait=%.1fms)",
             host, httpd.server_address[1], max_batch, max_wait_ms)
    try:
        httpd.serve_forever()
    finally:
        batcher.close()
        httpd.server_close()
