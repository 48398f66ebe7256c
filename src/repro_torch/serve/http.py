"""OpenAI-compatible HTTP frontend over :class:`repro_torch.serve.Engine`
(port of ``repro/serve/http.py``).

Dependency-free (stdlib ``http.server`` only): a ``ThreadingHTTPServer``
accepts connections, and a single background **pump thread** drives
``Engine.step()`` — handler threads never touch the device (the pump
sets the engine's CUDA device as current in its own thread). The pump
fans generated tokens out to per-connection queues through the engine's
``on_token`` hook, so `/v1/completions` and `/v1/chat/completions` can
stream Server-Sent Events token-by-token with the exact latency the
continuous scheduler delivers.

Endpoints:

  * ``POST /v1/completions``       — prompt as a string (byte-level
    tokenizer below) or a raw token-id list; ``stream: true`` for SSE.
  * ``POST /v1/chat/completions``  — ``messages`` rendered through a
    deterministic chat template (stable rendering keeps the radix
    prefix cache hot across turns of the same conversation).
  * ``GET /v1/models`` / ``/health`` / ``/metrics`` (Prometheus text) /
    ``/metrics.json`` (the ``Engine.stats()`` snapshot).

Per-request sampling maps straight onto
:class:`~repro_torch.serve.sampling.SamplingParams`: ``temperature``,
``top_p``, ``top_k``, ``seed``, ``stop_token_ids``, ``max_tokens``.
String ``stop`` sequences are rejected with a 400 — the repro tokenizer
is byte-level, so stop *token ids* are the faithful surface.

Client disconnect mid-stream calls ``Engine.abort(uid)``: the slot
frees and its pages decref on the next pump iteration, so an abandoned
long generation cannot pin pool pages or a decode lane.

The token text codec is the repro stand-in pair ``encode_text`` /
``detok`` (bytes mod vocab in, ``<id>`` pieces out) — deterministic,
reversible enough for tests, and trivially replaced by a real
tokenizer at integration time.
"""
from __future__ import annotations

import itertools
import json
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serve.engine import Engine, Request, Result
from repro_torch.serve.sampling import SamplingParams


# ==========================================================================
# Token <-> text stand-in codec
# ==========================================================================
def encode_text(text: str, vocab: int) -> np.ndarray:
    """Byte-level stand-in tokenizer: UTF-8 bytes folded into the model
    vocab. Deterministic, so identical prompts hit the prefix cache."""
    data = text.encode("utf-8")
    if not data:
        data = b"\x00"
    return np.asarray([b % vocab for b in data], np.int32)


def detok(token: int) -> str:
    """Stand-in detokenizer piece for one generated id."""
    return f"<{int(token)}>"


def render_chat(messages: List[Dict[str, str]], vocab: int) -> np.ndarray:
    """Deterministic chat template: ``<|role|>content<|end|>`` per
    message plus the assistant cue. Stable token rendering across turns
    keeps shared conversation prefixes radix-cache hot."""
    parts = []
    for m in messages:
        role = m.get("role", "user")
        content = m.get("content") or ""
        if not isinstance(content, str):
            raise ValueError("message content must be a string")
        parts.append(f"<|{role}|>{content}<|end|>")
    parts.append("<|assistant|>")
    return encode_text("".join(parts), vocab)


# ==========================================================================
# Engine pump: one thread steps the engine, fans tokens to streams
# ==========================================================================

# The Engine methods that mutate engine/scheduler state (or publish into
# the shared metrics registry) and therefore may only be called while
# holding ``EngineServer.cv``. This registry is the thread-safety
# contract: the lock-discipline pass (tools/analysis) proves every
# ``.engine.<name>`` call in this module for a name listed here happens
# under ``with self.cv:`` (or in ``__init__``, before the pump thread
# exists). Adding an engine call to a handler without the lock is a CI
# failure, not a code-review hope.
ENGINE_MUTATORS = frozenset({
    "submit", "abort", "step", "drain", "generate", "warmup",
    "stats", "prometheus", "write_trace",
})


class EngineServer:
    """Thread-safe bridge between HTTP handler threads and one Engine.

    All engine access happens under ``self.cv`` (handlers submit/abort,
    the pump steps); generated tokens and final results flow to the
    owning connection through a per-uid ``queue.Queue`` of
    ``("token", id) | ("done", Result) | ("error", message)`` events.
    """

    def __init__(self, engine: Engine, model_id: str = "repro-qlr"):
        if engine.sc.scheduler != "continuous":
            raise ValueError("EngineServer needs ServeConfig("
                             "scheduler='continuous')")
        self.engine = engine
        self.model_id = model_id
        self.cv = threading.Condition()
        self._streams: Dict[int, "queue.Queue"] = {}
        self._uids = itertools.count(1)
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.t_start = time.time()
        engine.on_token = self._on_token

    # -- pump side (holds cv) ------------------------------------------
    def _on_token(self, uid: int, token: int, info=None) -> None:
        """``info`` is the engine's logprob record (or None) — it rides
        the token event so streaming and collected responses can both
        render OpenAI ``logprobs`` without a second engine query."""
        q = self._streams.get(uid)
        if q is not None:
            q.put(("token", (token, info)))

    def _pump(self) -> None:
        eng = self.engine
        if eng.device.type == "cuda":
            # the card the model lives on (a tensor's device has an index)
            torch.cuda.set_device(eng.model.device)
        while True:
            with self.cv:
                while not self._stop and not eng.sched.has_work:
                    self.cv.wait()
                if self._stop:
                    return
                try:
                    finished = eng.step()
                except Exception as e:          # noqa: BLE001 — any step
                    # failure must fail every open stream, not hang them
                    for q in self._streams.values():
                        q.put(("error", f"{type(e).__name__}: {e}"))
                    self._streams.clear()
                    continue
                for res in finished:
                    q = self._streams.pop(res.uid, None)
                    if q is not None:
                        q.put(("done", res))
            # a step runs mostly in Python holding the interpreter lock:
            # hand it to the handler threads between steps, so they write
            # their tokens (and see a vanished client) while the request
            # still decodes
            time.sleep(0)

    def start(self) -> "EngineServer":
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="engine-pump")
        self._thread.start()
        return self

    def close(self) -> None:
        with self.cv:
            self._stop = True
            self.cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- handler side --------------------------------------------------
    def submit(self, prompt: np.ndarray,
               params: SamplingParams) -> Tuple[int, "queue.Queue"]:
        """Register a stream and queue the request; raises ValueError
        straight through (handler turns it into a 400)."""
        with self.cv:
            uid = next(self._uids)
            q: "queue.Queue" = queue.Queue()
            self._streams[uid] = q
            try:
                self.engine.submit(Request(uid=uid, prompt=prompt,
                                           params=params))
            except Exception:
                del self._streams[uid]
                raise
            self.cv.notify_all()
            return uid, q

    def abort(self, uid: int) -> None:
        with self.cv:
            self._streams.pop(uid, None)
            self.engine.abort(uid)

    def stats(self) -> Dict:
        with self.cv:
            return self.engine.stats()

    def prometheus(self) -> str:
        with self.cv:
            return self.engine.prometheus()


# ==========================================================================
# HTTP layer
# ==========================================================================
def _parse_params(body: Dict, chat: bool) -> SamplingParams:
    if body.get("stop") not in (None, [], ()):
        raise ValueError("string 'stop' sequences are not supported by "
                         "the byte-level repro tokenizer; pass "
                         "'stop_token_ids' (a list of token ids) instead")
    stop_ids = body.get("stop_token_ids") or []
    if not isinstance(stop_ids, list) \
            or not all(isinstance(t, int) for t in stop_ids):
        raise ValueError("stop_token_ids must be a list of token ids")
    mnt = body.get("max_tokens")
    if chat and mnt is None:
        mnt = body.get("max_completion_tokens")
    temp = body.get("temperature")
    # OpenAI surfaces: completions takes `logprobs: <int>`; chat takes
    # `logprobs: true` + `top_logprobs: <int>`. Both land on
    # SamplingParams.logprobs (validated 0..5 at submit)
    lp = body.get("logprobs")
    if chat:
        n_lp = int(body.get("top_logprobs", 0)) if lp else None
    else:
        n_lp = None if lp is None else int(lp)
    return SamplingParams(
        temperature=None if temp is None else float(temp),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", 0)),
        seed=body.get("seed"),
        stop=tuple(stop_ids),
        max_new_tokens=None if mnt is None else int(mnt),
        logprobs=n_lp)


class OpenAIHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "repro-serve"
    srv: EngineServer = None          # installed by serve_http()

    def log_message(self, fmt, *args):   # noqa: A003 — quiet by default
        pass

    # -- plumbing ------------------------------------------------------
    def _json(self, code: int, obj: Dict) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _text(self, code: int, text: str,
              ctype: str = "text/plain; charset=utf-8") -> None:
        data = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _error(self, code: int, message: str,
               etype: str = "invalid_request_error") -> None:
        self._json(code, {"error": {"message": message, "type": etype,
                                    "code": code}})

    def _begin_sse(self) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

    def _chunk(self, data: bytes) -> None:
        """One HTTP/1.1 chunked-transfer frame."""
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _sse(self, obj) -> None:
        payload = obj if isinstance(obj, str) else json.dumps(obj)
        self._chunk(f"data: {payload}\n\n".encode())

    def _end_chunks(self) -> None:
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    # -- GET -----------------------------------------------------------
    def do_GET(self):   # noqa: N802 — http.server API
        srv = self.srv
        if self.path == "/health":
            self._json(200, {"status": "ok",
                             "uptime_s": round(time.time() - srv.t_start, 3)})
        elif self.path == "/metrics":
            self._text(200, srv.prometheus(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif self.path == "/metrics.json":
            self._json(200, srv.stats())
        elif self.path == "/v1/models":
            self._json(200, {"object": "list", "data": [
                {"id": srv.model_id, "object": "model",
                 "created": int(srv.t_start), "owned_by": "repro"}]})
        else:
            self._error(404, f"unknown route {self.path}", "not_found_error")

    # -- POST ----------------------------------------------------------
    def do_POST(self):  # noqa: N802 — http.server API
        if self.path == "/v1/completions":
            self._completions(chat=False)
        elif self.path == "/v1/chat/completions":
            self._completions(chat=True)
        else:
            self._error(404, f"unknown route {self.path}", "not_found_error")

    def _read_body(self) -> Optional[Dict]:
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            return body
        except (ValueError, json.JSONDecodeError) as e:
            self._error(400, f"invalid JSON body: {e}")
            return None

    def _completions(self, chat: bool) -> None:
        srv = self.srv
        body = self._read_body()
        if body is None:
            return
        model = body.get("model", srv.model_id)
        if model != srv.model_id:
            self._error(404, f"model {model!r} not found (serving "
                        f"{srv.model_id!r})", "not_found_error")
            return
        vocab = srv.engine.cfg.vocab
        try:
            if chat:
                messages = body.get("messages")
                if not isinstance(messages, list) or not messages:
                    raise ValueError("'messages' must be a non-empty list")
                prompt = render_chat(messages, vocab)
            else:
                raw = body.get("prompt")
                if isinstance(raw, str):
                    prompt = encode_text(raw, vocab)
                elif isinstance(raw, list) \
                        and all(isinstance(t, int) for t in raw):
                    prompt = np.asarray(raw, np.int32)
                else:
                    raise ValueError("'prompt' must be a string or a "
                                     "list of token ids")
            params = _parse_params(body, chat)
            uid, q = srv.submit(prompt, params)
        except ValueError as e:
            self._error(400, str(e))
            return

        rid = (("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24])
        created = int(time.time())
        obj = "chat.completion.chunk" if chat else "text_completion"
        if body.get("stream"):
            self._stream(uid, q, rid, created, obj, chat, len(prompt))
        else:
            self._collect(uid, q, rid, created, chat, len(prompt))

    # -- response shapes -----------------------------------------------
    def _envelope(self, rid: str, created: int, obj: str) -> Dict:
        return {"id": rid, "object": obj, "created": created,
                "model": self.srv.model_id}

    def _stream(self, uid: int, q: "queue.Queue", rid: str, created: int,
                obj: str, chat: bool, n_prompt: int) -> None:
        srv = self.srv
        try:
            self._begin_sse()
            if chat:
                first = self._envelope(rid, created, obj)
                first["choices"] = [{"index": 0, "finish_reason": None,
                                     "delta": {"role": "assistant"}}]
                self._sse(first)
            while True:
                kind, val = q.get()
                if kind == "token":
                    tok, info = val
                    ev = self._envelope(rid, created, obj)
                    piece = detok(tok)
                    choice = {"index": 0, "finish_reason": None,
                              "token_ids": [int(tok)]}
                    if chat:
                        choice["delta"] = {"content": piece}
                        if info is not None:
                            choice["logprobs"] = self._lp_chat(
                                [tok], [info])
                    else:
                        choice["text"] = piece
                        if info is not None:
                            choice["logprobs"] = self._lp_completions(
                                [tok], [info])
                    ev["choices"] = [choice]
                    self._sse(ev)
                elif kind == "done":
                    res: Result = val
                    ev = self._envelope(rid, created, obj)
                    choice = {"index": 0,
                              "finish_reason": res.finish_reason or "stop"}
                    if chat:
                        choice["delta"] = {}
                    else:
                        choice["text"] = ""
                    ev["choices"] = [choice]
                    ev["usage"] = self._usage(n_prompt, len(res.tokens))
                    self._sse(ev)
                    self._sse("[DONE]")
                    self._end_chunks()
                    return
                else:    # ("error", message)
                    self._sse({"error": {"message": val,
                                         "type": "server_error"}})
                    self._end_chunks()
                    return
        except (BrokenPipeError, ConnectionResetError):
            # client went away mid-stream: cancel the request so its
            # slot and pages free instead of decoding to the budget
            srv.abort(uid)

    def _collect(self, uid: int, q: "queue.Queue", rid: str, created: int,
                 chat: bool, n_prompt: int) -> None:
        infos: List = []
        while True:
            kind, val = q.get()
            if kind == "token":
                infos.append(val[1])
                continue
            if kind == "done":
                res: Result = val
                break
            if kind == "error":
                self._error(500, val, "server_error")
                return
        text = "".join(detok(t) for t in res.tokens)
        out = self._envelope(rid, created,
                             "chat.completion" if chat else "text_completion")
        choice = {"index": 0, "finish_reason": res.finish_reason or "stop",
                  "token_ids": [int(t) for t in res.tokens]}
        if chat:
            choice["message"] = {"role": "assistant", "content": text}
        else:
            choice["text"] = text
        toks = [int(t) for t in res.tokens]
        if infos and len(infos) == len(toks) \
                and all(i is not None for i in infos):
            choice["logprobs"] = (self._lp_chat(toks, infos) if chat
                                  else self._lp_completions(toks, infos))
        out["choices"] = [choice]
        out["usage"] = self._usage(n_prompt, len(res.tokens))
        self._json(200, out)

    # -- OpenAI logprob shapes -----------------------------------------
    @staticmethod
    def _lp_completions(tokens: List[int], infos: List[Dict]) -> Dict:
        """Completions-style block: parallel arrays over positions."""
        return {"tokens": [detok(t) for t in tokens],
                "token_logprobs": [i["logprob"] for i in infos],
                "top_logprobs": [
                    {detok(t): lp for t, lp in i["top_logprobs"]}
                    for i in infos]}

    @staticmethod
    def _lp_chat(tokens: List[int], infos: List[Dict]) -> Dict:
        """Chat-style block: one content entry per position."""
        return {"content": [
            {"token": detok(t), "logprob": i["logprob"],
             "top_logprobs": [{"token": detok(tt), "logprob": ll}
                              for tt, ll in i["top_logprobs"]]}
            for t, i in zip(tokens, infos)]}

    @staticmethod
    def _usage(n_prompt: int, n_out: int) -> Dict:
        return {"prompt_tokens": n_prompt, "completion_tokens": n_out,
                "total_tokens": n_prompt + n_out}


class _HTTPServer(ThreadingHTTPServer):
    # listen backlog: at the stdlib's 5, a burst of concurrent clients
    # overflows the accept queue while the pump thread holds the
    # interpreter lock, and the kernel resets the connections it drops
    request_queue_size = 128
    daemon_threads = True


def serve_http(engine: Engine, host: str = "127.0.0.1", port: int = 8000,
               model_id: str = "repro-qlr"
               ) -> Tuple[ThreadingHTTPServer, EngineServer]:
    """Build the pump + HTTP server (not yet serving: call
    ``serve_forever()`` or drive it from a thread; ``port=0`` binds an
    ephemeral port, ``httpd.server_address[1]`` tells you which)."""
    srv = EngineServer(engine, model_id=model_id).start()
    handler = type("BoundHandler", (OpenAIHandler,), {"srv": srv})
    return _HTTPServer((host, port), handler), srv
