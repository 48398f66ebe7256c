"""Port parity for the OpenAI-compatible frontend
(``repro_torch.serve.http``): the port's server and the JAX package's,
each on an ephemeral port over the same model (reduced phi3, the JAX
params converted), answer the same requests.

* completions and chat completions, non-stream and SSE streams: the
  responses and every SSE frame equal apart from ``id`` and ``created``
  (logprob values within 1e-5 of their scale: the two frameworks' logits
  differ in the sixth significant digit), tokens equal to
  ``Engine.generate``'s; concurrent streams complete;
* error envelopes: status and message equal; ``/v1/models``, ``/health``,
  ``/metrics`` and ``/metrics.json`` answer alike;
* a client that vanishes mid-stream aborts its request and frees its
  slot and pages; a failing engine step fails every open stream;
* ``python -m repro_torch.launch.server --device cpu --smoke`` exits 0.
"""
import http.client
import json
import os
import re
import socket
import struct
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import init_lm as jinit_lm
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro.serve import serve_http as jserve_http
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.serve import (Engine, Request, SamplingParams, ServeConfig,
                               encode_text, render_chat, serve_http)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# prefill_len 48: the byte-level chat rendering runs 30–40 tokens, which
# must fit the unpaged prefill width. An f32 KV cache: in a bf16 one, K/V
# values that differ between the frameworks in the seventh digit can round
# to neighbouring bf16 values, which moves later logits by 1e-4
COMMON = dict(max_len=64, decode_batch=3, max_new_tokens=6, prefill_len=48,
              kv_dtype="f32")
LP_TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("phi3-mini-3.8b").reduced()
    params = jinit_lm(jax.random.PRNGKey(0), jcfg)
    model = convert_params(jax.tree_util.tree_map(np.asarray, params),
                           get_config("phi3-mini-3.8b").reduced(),
                           device="cpu")
    return jcfg, params, model


def _boot(serve, engine):
    httpd, srv = serve(engine, port=0, model_id="repro-test")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, srv


@pytest.fixture(scope="module")
def servers(models):
    """{"jax": port, "port": port} plus the port's engine."""
    jcfg, params, model = models
    booted = {
        "jax": _boot(jserve_http, JEngine(params, jcfg,
                                          JServeConfig(**COMMON))),
        "port": _boot(serve_http, Engine(model, model.cfg,
                                         ServeConfig(**COMMON),
                                         device="cpu"))}
    yield {k: h.server_address[1] for k, (h, _) in booted.items()}, \
        booted["port"][1].engine
    for httpd, srv in booted.values():
        httpd.shutdown()
        srv.close()
        httpd.server_close()


def _request(port, method, path, body=None, raw=None, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    data = raw if raw is not None else (None if body is None
                                        else json.dumps(body))
    conn.request(method, path, data, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, resp.read(), resp.getheader("Content-Type", "")
    conn.close()
    return out


def _post(port, path, body):
    status, data, _ = _request(port, "POST", path, body)
    return status, json.loads(data)


def _stream(port, path, body):
    status, data, _ = _request(port, "POST", path, dict(body, stream=True))
    assert status == 200, data
    return [f[len("data: "):] for f in
            (s.strip() for s in data.decode().split("\n\n"))
            if f.startswith("data: ")]


def _close(got, want, path="$"):
    """``got`` equals ``want`` apart from ``id``/``created``, floats within
    LP_TOL of their scale."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k, w in want.items():
            if k not in ("id", "created"):
                _close(got[k], w, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= LP_TOL * max(1.0, abs(want)), path
    else:
        assert got == want, path


COMPLETIONS = [
    ("/v1/completions", {"prompt": "hello world", "max_tokens": 4}),
    ("/v1/completions", {"prompt": [5, 6, 7], "max_tokens": 3}),
    ("/v1/completions", {"prompt": "parity check prompt", "max_tokens": 6,
                         "temperature": 0.9, "top_p": 0.8, "top_k": 7,
                         "seed": 123}),
    ("/v1/completions", {"prompt": "logprob check", "max_tokens": 4,
                         "logprobs": 2}),
    ("/v1/chat/completions", {"messages": [{"role": "user",
                                            "content": "hi"}],
                              "max_tokens": 3, "logprobs": True,
                              "top_logprobs": 2}),
]


@pytest.mark.parametrize("path,body", COMPLETIONS,
                         ids=["text", "token_ids", "sampled", "logprobs",
                              "chat_logprobs"])
def test_completion_matches_jax(servers, path, body):
    ports, _ = servers
    want = _post(ports["jax"], path, body)
    got = _post(ports["port"], path, body)
    assert got[0] == want[0] == 200
    _close(got[1], want[1])


@pytest.mark.parametrize("path,body", [COMPLETIONS[0], COMPLETIONS[3],
                                       COMPLETIONS[4]],
                         ids=["text", "logprobs", "chat_logprobs"])
def test_stream_frames_match_jax(servers, path, body):
    ports, _ = servers
    want = _stream(ports["jax"], path, body)
    got = _stream(ports["port"], path, body)
    assert got[-1] == want[-1] == "[DONE]"
    _close([json.loads(f) for f in got[:-1]],
           [json.loads(f) for f in want[:-1]])


def test_stream_matches_generate(models, servers):
    """Streamed tokens are what ``Engine.generate`` gives for the same
    prompt and ``SamplingParams`` — greedy and seeded-sampled."""
    _, _, model = models
    ports, _ = servers
    prompt = "parity check prompt"
    ids = encode_text(prompt, model.cfg.vocab)
    ref = Engine(model, model.cfg, ServeConfig(**COMMON),
                 device="cpu").generate([
                     Request(uid=1, prompt=ids,
                             params=SamplingParams(max_new_tokens=6)),
                     Request(uid=2, prompt=ids, params=SamplingParams(
                         temperature=0.9, top_p=0.8, top_k=7, seed=123,
                         max_new_tokens=6))])
    for body, want in [({"prompt": prompt, "max_tokens": 6}, ref[0]),
                       ({"prompt": prompt, "max_tokens": 6,
                         "temperature": 0.9, "top_p": 0.8, "top_k": 7,
                         "seed": 123}, ref[1])]:
        frames = _stream(ports["port"], "/v1/completions", body)
        toks = [json.loads(f)["choices"][0]["token_ids"][0]
                for f in frames[:-2]]
        assert toks == want.tokens.tolist()
    chat = render_chat([{"role": "user", "content": "hi"}], model.cfg.vocab)
    assert chat.tolist() == list(b"<|user|>hi<|end|><|assistant|>")


def test_concurrent_streams(servers):
    ports, _ = servers
    results = {}

    def worker(i):
        results[i] = _stream(ports["port"], "/v1/completions",
                             {"prompt": f"client {i}", "max_tokens": 6})

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i in range(4):
        assert results[i][-1] == "[DONE]"
        events = [json.loads(f) for f in results[i][:-1]]
        assert sum(1 for e in events if e["choices"][0].get("text")) == 6


BAD = [("/v1/completions", {"prompt": 42}, None),
       ("/v1/completions", None, "{broken"),
       ("/v1/completions", None, "[1, 2]"),
       ("/v1/chat/completions", {"messages": []}, None),
       ("/v1/chat/completions", {"messages": [{"content": 3}]}, None),
       ("/v1/completions", {"prompt": "x", "stop": ["\n"]}, None),
       ("/v1/completions", {"prompt": "x", "stop_token_ids": "1"}, None),
       ("/v1/completions", {"prompt": "x", "model": "gpt-4"}, None),
       ("/v1/completions", {"prompt": "y" * 80}, None),
       ("/v1/completions", {"prompt": "y" * 50}, None),
       ("/v1/completions", {"prompt": "x", "max_tokens": 1, "logprobs": 9},
        None),
       ("/v1/completions", {"prompt": "x", "temperature": -1.0}, None),
       ("/v1/nope", {}, None)]


@pytest.mark.parametrize("path,body,raw", BAD,
                         ids=[f"bad{i}" for i in range(len(BAD))])
def test_error_envelopes_match_jax(servers, path, body, raw):
    ports, _ = servers
    got, want = ({k: _request(p, "POST", path, body, raw)[:2]
                  for k, p in ports.items()}[k] for k in ("port", "jax"))
    assert got[0] == want[0] and got[0] in (400, 404)
    # a request's uid is the server's own count of what it was sent
    uid = re.compile(r"request \d+:")
    assert uid.sub("request <uid>:", got[1].decode()) == \
        uid.sub("request <uid>:", want[1].decode())


def test_introspection_routes_match_jax(servers):
    ports, _ = servers
    out = {k: {r: _request(p, "GET", r) for r in
               ("/health", "/v1/models", "/metrics", "/metrics.json",
                "/nope")}
           for k, p in ports.items()}
    for route in ("/health", "/v1/models", "/metrics", "/metrics.json"):
        assert out["port"][route][0] == out["jax"][route][0] == 200
        assert out["port"][route][2] == out["jax"][route][2]
    assert json.loads(out["port"]["/health"][1])["status"] == "ok"
    _close(json.loads(out["port"]["/v1/models"][1]),
           json.loads(out["jax"]["/v1/models"][1]))
    types = {k: {ln for ln in o["/metrics"][1].decode().splitlines()
                 if ln.startswith("# TYPE")} for k, o in out.items()}
    assert types["port"] == types["jax"]
    assert set(json.loads(out["port"]["/metrics.json"][1])) == \
        set(json.loads(out["jax"]["/metrics.json"][1]))
    assert out["port"]["/nope"][:2] == out["jax"]["/nope"][:2]


def test_disconnect_aborts_request(models):
    """A client that vanishes mid-stream aborts its request: the slot
    frees, its pages return, the aborted counter ticks."""
    _, _, model = models
    eng = Engine(model, model.cfg, ServeConfig(
        **dict(COMMON, paged=True, page_size=8, max_len=512,
               max_new_tokens=400, prefill_len=16)), device="cpu")
    httpd, srv = _boot(serve_http, eng)
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          httpd.server_address[1],
                                          timeout=120)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": "runaway generation",
                                 "stream": True, "max_tokens": 400}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read(64)
        # a reset, not a FIN, so the server's next chunk write fails
        conn.sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                             struct.pack("ii", 1, 0))
        resp.close()
        conn.close()
        deadline = time.time() + 60
        while time.time() < deadline:
            st = srv.stats()
            if st["aborted"] >= 1 and eng.sched.table.n_active == 0:
                break
            time.sleep(0.1)
        st = srv.stats()
        assert st["aborted"] == 1 and eng.sched.table.n_active == 0
        assert st["pages_hot"] == eng.sc.decode_batch  # only parked pages
        assert st["retired"] == 1
    finally:
        httpd.shutdown()
        srv.close()
        httpd.server_close()


def test_step_failure_fails_open_streams(models, monkeypatch):
    _, _, model = models
    eng = Engine(model, model.cfg, ServeConfig(**COMMON), device="cpu")

    def broken():
        raise RuntimeError("device lost")

    monkeypatch.setattr(eng, "step", broken)
    httpd, srv = _boot(serve_http, eng)
    try:
        port = httpd.server_address[1]
        frames = _stream(port, "/v1/completions", {"prompt": "x"})
        assert json.loads(frames[-1]) == {"error": {
            "message": "RuntimeError: device lost", "type": "server_error"}}
        status, out = _post(port, "/v1/completions", {"prompt": "x"})
        assert status == 500 and "device lost" in out["error"]["message"]
    finally:
        httpd.shutdown()
        srv.close()
        httpd.server_close()


def test_server_cli_smoke_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.server", "--device", "cpu",
         "--smoke"], capture_output=True, text=True, cwd=REPO, env=env,
        timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[smoke] PASS" in proc.stdout
    assert "validates against tools/metrics_schema.json" in proc.stdout
