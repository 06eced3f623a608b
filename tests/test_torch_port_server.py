"""The port's HTTP serving tier on the CPU: the behaviours of
tests/test_server.py against ``fastspeech2_tpu_torch.infer.server``.

A real server (ephemeral port, ``conftest.small_cfg`` widths, seeded
weights, ``device="cpu"``) runs in a thread and is spoken to over the
socket. Every socket call has a timeout and every server is stopped through
its stop event, which closes the batcher and the socket.
"""

import contextlib
import http.client
import json
import socket
import struct
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from conftest import small_cfg
from fastspeech2_tpu_torch.config import config_from_dict
from fastspeech2_tpu_torch.infer.server import Batcher, serve
from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_tpu_torch.vocoder.melgan import MelGANConfig, MelGANGenerator

CFG = config_from_dict(small_cfg().to_dict())


def _synth(**kw):
    torch.manual_seed(0)
    model = FastSpeech2(CFG, device="cpu")
    with torch.no_grad():
        model.duration_predictor.out.bias.fill_(1.0)
    return Synthesizer(model, device="cpu", **kw)


@contextlib.contextmanager
def _running(synth, **kw):
    """serve() in a thread on an ephemeral port; stopped and joined on exit."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ready, stop = threading.Event(), threading.Event()
    t = threading.Thread(target=serve, args=(synth, CFG), daemon=True,
                         kwargs=dict(host="127.0.0.1", port=port, max_wait_ms=20.0,
                                     ready_event=ready, stop_event=stop, **kw))
    t.start()
    assert ready.wait(timeout=30)
    try:
        yield f"http://127.0.0.1:{port}"
    finally:
        stop.set()
        t.join(timeout=30)
        assert not t.is_alive(), "the server did not shut down"


@pytest.fixture(scope="module")
def server():
    with _running(_synth()) as url:
        yield url


@pytest.fixture(scope="module")
def wav_server():
    """A server whose synthesizer has a MelGAN generator attached (the fused
    text -> wav path)."""
    synth = _synth()
    synth.attach_vocoder(MelGANGenerator(MelGANConfig(base_channels=16), seed=1,
                                         device="cpu"))
    with _running(synth) as url:
        yield url


def _post(url, payload, path="/synthesize"):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.headers, r.read()


def _status(url, payload, path="/synthesize"):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, payload, path)
    return e.value.code, json.loads(e.value.read())


def _healthz(url):
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        return json.loads(r.read())


def test_healthz(server):
    obj = _healthz(server)
    assert obj["status"] == "ok" and {"requests", "batches", "frames"} <= set(obj)


def test_synthesize_phonemes_mel(server):
    headers, body = _post(server, {"phonemes": "HH AH0 L OW1 W ER1 L D"})
    obj = json.loads(body)
    assert "application/json" in headers["Content-Type"]
    mel = np.asarray(obj["mel"], np.float32)
    assert mel.ndim == 2 and mel.shape[1] == 80 and obj["frames"] == len(mel) > 0


def test_text_and_phonemes_reach_the_same_tokens(server):
    """{"text": ...} goes through the port's G2P: 'hello world' is in the
    lexicon, so it gives the mel of its phoneme string."""
    from fastspeech2_tpu_torch.text.g2p import preprocess_text

    a = json.loads(_post(server, {"text": "hello world"})[1])
    b = json.loads(_post(server, {"phonemes": preprocess_text("hello world")})[1])
    assert a["frames"] == b["frames"] > 0
    np.testing.assert_allclose(np.asarray(a["mel"]), np.asarray(b["mel"]), atol=1e-5)


def test_wav_without_vocoder_is_501(server):
    """The JAX server falls back to Griffin-Lim here; until audio/ is ported
    the port answers 501 and names what is missing."""
    for path in ("/synthesize", "/stream"):
        code, obj = _status(server, {"text": "hello world", "format": "wav"}, path)
        assert code == 501 and "griffin_lim" in obj["error"]
    assert _healthz(server)["status"] == "ok"  # still serving


def test_text_wav_through_vocoder_callable():
    """serve(vocoder=callable): the mel path batches, the callable vocodes
    each finished mel; L * hop samples of 16-bit PCM."""
    calls = []

    def voc(mel):
        calls.append(mel.shape)
        return np.full((mel.shape[0] * 256,), 0.25, np.float32)

    with _running(_synth(), vocoder=voc) as url:
        headers, body = _post(url, {"text": "hello world", "format": "wav"})
    assert headers["Content-Type"] == "audio/wav" and body[:4] == b"RIFF"
    n = struct.unpack("<I", body[40:44])[0] // 2
    assert n == calls[0][0] * 256 > 0
    pcm = np.frombuffer(body[44:], "<i2")
    assert np.all(pcm == 8192)  # round(0.25 * 32767) to even


def test_concurrent_requests_batch(server):
    results = [None] * 6

    def go(i):
        results[i] = json.loads(_post(server, {"phonemes": "HH AH0 L OW1"})[1])["frames"]

    threads = [threading.Thread(target=go, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert all(isinstance(r, int) and r > 0 for r in results)
    assert len(set(results)) == 1  # one sentence, one answer, whatever the batch
    stats = _healthz(server)
    assert stats["batches"] < stats["requests"]  # coalescing happened
    # a burst of clients must fit the listen backlog (the default of 5 drops
    # SYNs, which are retried a second later)
    from fastspeech2_tpu_torch.infer.server import _HTTPServer
    assert _HTTPServer.request_queue_size >= 64


def test_stream_multi_sentence_wav(wav_server):
    def stream(text):
        req = urllib.request.Request(
            wav_server + "/stream", data=json.dumps({"text": text}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.headers.get("Content-Type") == "audio/wav"
            assert r.headers.get("Transfer-Encoding") == "chunked"
            return r.read()  # urllib decodes the chunked framing

    one = stream("hello world.")
    three = stream("hello world. good morning there. the stream keeps going.")
    for body in (one, three):
        assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
        assert body[4:8] == b"\xff\xff\xff\xff"  # streaming header: unknown sizes
        assert len(body) > 44 and (len(body) - 44) % (2 * 256) == 0
    assert len(three) > len(one)
    # the first sentence's audio is the same bytes in both streams
    assert three[44:len(one)] == one[44:]


def test_stream_bad_input(wav_server):
    # unphonemizable text, unknown phoneme symbols (a client's 400, not a
    # 500), and a sentence-count flood are all refused up front
    for payload in ({"text": "..!?"}, {"phonemes": "HH QQ9"}, {"text": "a." * 300}):
        code, _ = _status(wav_server, payload, "/stream")
        assert code == 400, payload


def test_negative_content_length_400(server):
    host, port = server.removeprefix("http://").split(":")
    c = http.client.HTTPConnection(host, int(port), timeout=30)
    c.putrequest("POST", "/synthesize")
    c.putheader("Content-Length", "-5")
    c.endheaders()
    r = c.getresponse()
    assert r.status == 400
    r.read()
    c.close()


def test_oversized_body_413(server):
    code, _ = _status(server, {"text": "x" * (2 << 20)})
    assert code == 413


@pytest.mark.parametrize("payload", [
    {}, {"format": "midi", "text": "x"}, 123, [1, 2], {"text": "x", "alpha": None},
    {"text": "x", "alpha": [1]}, {"text": "x", "alpha": 0}, {"text": "x", "alpha": 11},
    {"phonemes": 5}, {"phonemes": "HH QQ9"}, {"text": "..!?"}])
def test_bad_requests_400(server, payload):
    code, obj = _status(server, payload)
    assert code == 400 and obj["error"]


def test_unknown_paths_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server + "/nope", timeout=30)
    assert e.value.code == 404
    code, _ = _status(server, {"text": "x"}, "/nope")
    assert code == 404


def test_truncated_response_is_marked():
    """A request capped by max_frames comes back flagged (JSON "truncated",
    wav X-Truncated header), never silently shortened."""
    synth = _synth(max_frames=256)
    synth.attach_vocoder(MelGANGenerator(MelGANConfig(base_channels=16), seed=1,
                                         device="cpu"))
    ph = " ".join(["HH AH0 L OW1 W ER1 L D pau"] * 20)  # 180 tokens
    with _running(synth) as url:
        obj = json.loads(_post(url, {"phonemes": ph, "alpha": 10.0})[1])
        assert obj.get("truncated") is True and obj["frames"] == len(obj["mel"]) == 256
        headers, body = _post(url, {"phonemes": ph, "alpha": 10.0, "format": "wav"})
        assert headers.get("X-Truncated") == "1"
        assert struct.unpack("<I", body[40:44])[0] // 2 == 256 * 256
        headers, body = _post(url, {"phonemes": "HH AH0 L OW1"})
        assert "truncated" not in json.loads(body)
        assert _healthz(url)["truncated"] == 2


def test_batcher_direct():
    """Batcher coalesces queued requests into one forward call and closes
    both of its threads."""
    calls = []

    class FakeSynth:
        def mel_from_token_batch_async(self, seqs, alpha=1.0):
            calls.append(len(seqs))

            def finish():
                lens = np.asarray([3] * len(seqs))
                return (np.zeros((len(seqs), 5, 80), np.float32), lens,
                        np.zeros(len(seqs), bool))

            return finish

    b = Batcher(FakeSynth(), max_batch=8, max_wait_ms=50.0)
    reqs = [b.submit(np.asarray([1, 2, 3], np.int64)) for _ in range(5)]
    for r in reqs:
        assert r.done.wait(timeout=10)
        assert r.mel.shape == (3, 80) and r.error is None
    b.close()
    assert not b.thread.is_alive() and not b.delivery_thread.is_alive()
    assert sum(calls) == 5 and len(calls) <= 2  # coalesced, not 5 x B=1
    assert b.stats["requests"] == 5 and b.stats["frames"] == 15


def test_batcher_surfaces_failures_per_request():
    """A batch whose dispatch or finish raises fails its own requests and
    the batcher keeps serving the next ones."""
    class Flaky:
        n = 0

        def mel_from_token_batch_async(self, seqs, alpha=1.0):
            self.n += 1
            if self.n == 1:
                raise ValueError("bad alpha")

            def finish():
                if self.n == 2:
                    raise RuntimeError("device fell over")
                return (np.zeros((len(seqs), 4, 80), np.float32),
                        np.asarray([2] * len(seqs)), np.zeros(len(seqs), bool))

            return finish

    b = Batcher(Flaky(), max_batch=1, max_wait_ms=1.0)
    try:
        errors = []
        for _ in range(3):
            r = b.submit(np.asarray([1], np.int64))
            assert r.done.wait(timeout=10)
            errors.append(r.error)
        assert errors == ["bad alpha", "device fell over", None]
    finally:
        b.close()


def test_fused_tts_over_the_socket(wav_server):
    """The attached vocoder serves wav from the single fused path; the same
    request as mel still works and has wav_len / hop frames."""
    ph = "HH AH0 L OW1 W ER1 L D"
    headers, body = _post(wav_server, {"phonemes": ph, "format": "wav"})
    assert headers["Content-Type"] == "audio/wav" and body[:4] == b"RIFF"
    n = struct.unpack("<I", body[40:44])[0] // 2
    assert n > 0 and n % 256 == 0 and len(body) == 44 + 2 * n
    obj = json.loads(_post(wav_server, {"phonemes": ph, "format": "mel"})[1])
    assert obj["frames"] == n // 256 and np.asarray(obj["mel"]).shape == (n // 256, 80)


def test_fused_tts_concurrent_mixed_alpha(wav_server):
    """Requests with different speeds share a batch; slower speech is longer."""
    out = {}

    def go(alpha):
        _, body = _post(wav_server, {"text": "good morning there", "format": "wav",
                                     "alpha": alpha})
        out[alpha] = struct.unpack("<I", body[40:44])[0] // 2

    threads = [threading.Thread(target=go, args=(a,)) for a in (0.5, 1.0, 2.0)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert out[0.5] < out[1.0] < out[2.0]
