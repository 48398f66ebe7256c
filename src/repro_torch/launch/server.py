"""HTTP serving driver: ``python -m repro_torch.launch.server [...]``
(port of ``repro.launch.server``).

Builds the paper's deployment artifact (init → calibrate → SRR-quantize,
the pipeline of ``repro_torch.launch.serve``) on the card (``--device
cuda``, the default; ``--device cpu`` runs the kernels' plain versions)
and exposes it through the OpenAI-compatible frontend
(``repro_torch.serve.http``): streaming `/v1/completions` +
`/v1/chat/completions`, `/v1/models`, `/health`, `/metrics`
(Prometheus) and `/metrics.json`.

``--smoke`` boots the server on an ephemeral port, streams one chat
completion through a real HTTP client, validates the SSE protocol and
the metrics snapshot against ``tools/metrics_schema.json``, and exits
0/1. The schema requires the per-phase histograms only telemetry records
and the page-pool and prefix series only the paged engine publishes, so
``--smoke`` turns on ``--telemetry`` and ``--paged``.
"""
from __future__ import annotations

import argparse
import http.client
import importlib.util
import json
import threading
from pathlib import Path

from repro_torch.launch.serve import add_model_args, build_quantized_model
from repro_torch.serve import Engine, ServeConfig, serve_http


def build_engine(args) -> Engine:
    model, cfg = build_quantized_model(args, tag="server")
    eng = Engine(model, cfg, ServeConfig(
        max_len=args.max_len, decode_batch=args.batch,
        max_new_tokens=args.new_tokens, eos_id=args.eos_id,
        kv_dtype=args.kv, temperature=args.temperature,
        prefill_len=args.prefill_len, seed=args.seed, fused=args.fused,
        paged=args.paged, page_size=args.page_size,
        max_step_tokens=args.max_step_tokens,
        speculative=args.spec_k > 0,
        spec_k=args.spec_k if args.spec_k > 0 else 4,
        max_pages_per_request=args.max_pages_per_request,
        free_watermark=args.free_watermark, telemetry=args.telemetry,
        sanitize=args.sanitize,
        drift_monitor=args.drift_monitor,
        drift_sample_rate=args.drift_sample_rate,
        drift_ref_fused=args.drift_ref_fused), device=args.device)
    print("[server] warming up (kernel builds + first launches)...")
    eng.warmup()
    return eng


def main(argv=None):
    p = argparse.ArgumentParser()
    add_model_args(p)
    p.add_argument("--kv", default="f32",
                   choices=["f32", "bf16", "int8", "int4"])
    p.add_argument("--batch", type=int, default=4,
                   help="decode lanes (concurrent requests)")
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--new-tokens", type=int, default=32,
                   help="default max_new_tokens when a request sends none")
    p.add_argument("--eos-id", type=int, default=-1)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="default temperature when a request sends none")
    p.add_argument("--prefill-len", type=int, default=32)
    p.add_argument("--fused", default="auto", choices=["auto", "on", "off"])
    p.add_argument("--paged", action="store_true")
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--max-step-tokens", type=int, default=None,
                   help="token-budget step scheduler (see ServeConfig)")
    p.add_argument("--spec-k", type=int, default=0,
                   help="self-speculative decoding draft depth (0 = off; "
                        "greedy continuous-batching lanes only)")
    p.add_argument("--max-pages-per-request", type=int, default=None)
    p.add_argument("--free-watermark", type=float, default=0.0)
    p.add_argument("--telemetry", action="store_true")
    p.add_argument("--sanitize", action="store_true",
                   help="audit serve-state invariants after every step "
                        "(see repro.serve.sanitizer); token-identical "
                        "but host-syncing — smoke/debug use")
    p.add_argument("--drift-monitor", action="store_true",
                   help="sampled shadow comparison of serving vs "
                        "reference-lowering logits; drift histograms + "
                        "NaN/inf guard counters land in /metrics.json")
    p.add_argument("--drift-sample-rate", type=float, default=0.05)
    p.add_argument("--drift-ref-fused", default="off",
                   choices=["auto", "on", "off"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--model-id", default="repro-qlr")
    p.add_argument("--smoke", action="store_true",
                   help="boot on an ephemeral port, stream one chat "
                        "completion over real HTTP, validate SSE + "
                        "metrics schema, exit 0/1")
    args = p.parse_args(argv)
    if args.smoke:
        # the smoke validates the full metrics schema, which includes the
        # per-phase step histograms only telemetry records and the page
        # and prefix series only the paged engine publishes
        args.telemetry = True
        args.paged = True

    eng = build_engine(args)
    httpd, srv = serve_http(eng, host=args.host,
                            port=0 if args.smoke else args.port,
                            model_id=args.model_id)
    host, port = httpd.server_address[:2]
    if args.smoke:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            ok = run_smoke(host, port, args.model_id,
                           spec=args.spec_k > 0)
        finally:
            httpd.shutdown()
            srv.close()
        return 0 if ok else 1
    print(f"[server] serving {args.model_id} on http://{host}:{port} "
          f"(/v1/completions, /v1/chat/completions, /metrics)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        srv.close()
    return 0


# ==========================================================================
# --smoke: end-to-end protocol check over a real socket
# ==========================================================================
def _fail(msg: str) -> bool:
    print(f"[smoke] FAIL: {msg}")
    return False


def _get_json(host, port, path):
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.request("GET", path)
    r = conn.getresponse()
    body = r.read()
    conn.close()
    return r.status, json.loads(body)


def run_smoke(host: str, port: int, model_id: str,
              spec: bool = False) -> bool:
    # -- health + models ------------------------------------------------
    status, health = _get_json(host, port, "/health")
    if status != 200 or health.get("status") != "ok":
        return _fail(f"/health: {status} {health}")
    status, models = _get_json(host, port, "/v1/models")
    if status != 200 or models["data"][0]["id"] != model_id:
        return _fail(f"/v1/models: {status} {models}")

    # -- streamed chat completion --------------------------------------
    conn = http.client.HTTPConnection(host, port, timeout=120)
    body = json.dumps({
        "model": model_id, "stream": True, "max_tokens": 8,
        "messages": [{"role": "user", "content": "smoke test prompt"}]})
    conn.request("POST", "/v1/chat/completions", body,
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        return _fail(f"chat stream: HTTP {resp.status} {resp.read()!r}")
    # http.client decodes the chunked transfer encoding transparently
    frames = []
    for raw in resp.read().decode().split("\n\n"):
        raw = raw.strip()
        if raw.startswith("data: "):
            frames.append(raw[len("data: "):])
    conn.close()
    if not frames or frames[-1] != "[DONE]":
        return _fail(f"SSE must end with [DONE] (got {frames[-2:]})")
    events = [json.loads(f) for f in frames[:-1]]
    if not events:
        return _fail("no SSE data events before [DONE]")
    if events[0]["choices"][0]["delta"].get("role") != "assistant":
        return _fail(f"first delta must carry the role: {events[0]}")
    for ev in events:
        if ev.get("object") != "chat.completion.chunk":
            return _fail(f"bad object type: {ev.get('object')}")
        if not ev.get("id", "").startswith("chatcmpl-"):
            return _fail(f"bad id: {ev.get('id')}")
    finishes = [ev["choices"][0].get("finish_reason") for ev in events]
    if finishes[-1] not in ("stop", "length"):
        return _fail(f"last chunk finish_reason: {finishes[-1]}")
    if any(f is not None for f in finishes[:-1]):
        return _fail("finish_reason must be null until the final chunk")
    n_tokens = sum(1 for ev in events
                   if ev["choices"][0].get("delta", {}).get("content"))
    if n_tokens < 1:
        return _fail("no content deltas streamed")
    print(f"[smoke] chat stream OK: {n_tokens} content deltas, "
          f"finish_reason={finishes[-1]}")

    # -- non-stream completion + usage ---------------------------------
    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request("POST", "/v1/completions",
                 json.dumps({"model": model_id, "prompt": "hello smoke",
                             "max_tokens": 4}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    if resp.status != 200:
        return _fail(f"completions: HTTP {resp.status} {out}")
    usage = out.get("usage", {})
    if usage.get("completion_tokens") != 4:
        return _fail(f"usage: {usage}")
    if out["choices"][0].get("finish_reason") != "length":
        return _fail(f"finish_reason: {out['choices'][0]}")

    # -- metrics: Prometheus text + JSON schema ------------------------
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.request("GET", "/metrics")
    resp = conn.getresponse()
    prom = resp.read().decode()
    conn.close()
    if resp.status != 200 or "# TYPE" not in prom:
        return _fail("/metrics has no Prometheus TYPE lines")
    status, snap = _get_json(host, port, "/metrics.json")
    if status != 200:
        return _fail(f"/metrics.json: {status}")
    if snap.get("retired", 0) < 2:
        return _fail(f"metrics.json retired={snap.get('retired')}")
    if spec:
        # the greedy smoke requests must actually take the speculative
        # path: rounds recorded + draft/accept counters consistent
        if snap.get("spec_rounds", 0) < 1:
            return _fail(f"spec_rounds={snap.get('spec_rounds')} with "
                         "speculation enabled")
        if snap.get("spec_accepted_tokens", 0) > \
                snap.get("spec_draft_tokens", 0):
            return _fail("spec_accepted_tokens > spec_draft_tokens")
        print(f"[smoke] speculative: {snap['spec_rounds']} rounds, "
              f"acceptance rate {snap.get('spec_acceptance_rate')}")
    root = Path(__file__).resolve().parents[3]
    schema_path = root / "tools" / "metrics_schema.json"
    validator = root / "tools" / "validate_metrics.py"
    if schema_path.exists() and validator.exists():
        spec = importlib.util.spec_from_file_location("validate_metrics",
                                                      validator)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        schema = json.loads(schema_path.read_text())
        errors = mod.validate(snap, schema, schema)
        if errors:
            return _fail("metrics schema: " + "; ".join(errors[:5]))
        print("[smoke] /metrics.json validates against "
              "tools/metrics_schema.json")
    else:
        return _fail(f"metrics schema tooling not found under {root}")

    # -- error envelope -------------------------------------------------
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.request("POST", "/v1/completions", "{not json",
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    err = json.loads(resp.read())
    conn.close()
    if resp.status != 400 or "error" not in err:
        return _fail(f"bad-JSON envelope: {resp.status} {err}")

    print("[smoke] PASS")
    return True


if __name__ == "__main__":
    raise SystemExit(main())
