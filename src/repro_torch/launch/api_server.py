"""OpenAI-compatible API server over the port's DVI serving engine.  Port of
``repro.launch.api_server``.

Builds the tiny-backbone serving stack (``serving.config.ModelSpec``
recipe: init -> synthetic pretrain -> online trainer state; on the card
unless ``--device cpu``), runs the engine on a dedicated thread
(``serving.http.EngineDriver``), captures its graphs there before taking
traffic, and serves:

  POST /v1/completions   (``"stream": true`` -> SSE)
  GET  /v1/models
  GET  /metrics          (Prometheus text)
  GET  /healthz

Prompts are token-id lists — this repo serves a synthetic vocab:

  PYTHONPATH=src python -m repro_torch.launch.api_server --port 8000 --tiny \\
      --kv-pages 64 --prefix-cache --prefill-chunk 8 &
  curl -N localhost:8000/v1/completions -d \\
      '{"prompt": [3, 17, 42], "max_tokens": 16, "stream": true}'

Graceful shutdown (SIGTERM/SIGINT): stop accepting connections, join
in-flight handler threads (the engine keeps stepping, so open SSE
streams run to completion), drain the engine, exit 0.
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading

from repro_torch.serving.config import (EngineConfig, ModelSpec,
                                        build_engine, build_model_bundle)
from repro_torch.serving.http import ApiServer, EngineDriver


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--request-timeout", type=float, default=300.0,
                    help="per-request (and per-SSE-chunk) wait bound")
    ModelSpec.add_args(ap)
    EngineConfig.add_args(ap, EngineConfig(max_new=32))
    args = ap.parse_args(argv)
    spec = ModelSpec.from_args(args)
    econf = EngineConfig.from_args(args)

    print(f"[api] building model: arch={spec.arch} tiny={spec.tiny} "
          f"seed={spec.seed} pretrain_steps={spec.pretrain_steps}",
          flush=True)
    _cfg, model, params, _tasks, state = build_model_bundle(spec)
    engine = build_engine(econf, model, params, state)
    driver = EngineDriver(engine).start()
    # capture the graphs on the engine's thread before any handler thread
    # exists (capturing synchronises and takes seconds at full size)
    driver.call(engine.warmup, timeout=1800.0)
    srv = ApiServer((args.host, args.port), driver,
                    model_id=f"{spec.arch}{'-tiny' if spec.tiny else ''}",
                    default_max_new=econf.max_new,
                    request_timeout_s=args.request_timeout)

    def _shutdown(signum, frame):
        # shutdown() must not run on the serve_forever thread; hand it off
        print(f"[api] signal {signum}: draining...", flush=True)
        threading.Thread(target=srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)

    print(f"[api] serving on http://{args.host}:{args.port} "
          f"(scheduler={econf.scheduler}, slots={econf.num_slots}, "
          f"max_queue={econf.max_queue or 'unbounded'})", flush=True)
    try:
        srv.serve_forever(poll_interval=0.1)
    finally:
        # order matters: close the listener and JOIN in-flight handler
        # threads FIRST (non-daemon; the driver is still stepping, so open
        # streams finish), THEN drain + stop the engine thread
        srv.server_close()
        driver.stop(drain=True)
    print("[api] drained; exit 0", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
