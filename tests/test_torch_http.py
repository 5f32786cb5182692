"""The port's HTTP front-end (the checks of tests/test_http.py): routes,
400 on a bad body, SSE == blocking == engine-direct streams, the text
field, disconnect -> cancel at a boundary, 429 backpressure; the payload
and prompt parsers give the reference's outputs.  One module-scoped
server over the port's engine (tiny vicuna-7b, float32, on the CPU, on its
driver thread) serves every test, and one over the prefix cache checks
that its SSE streams are the streams of the engine called directly without
it."""
import json
import socket
import struct
import threading
import time
import http.client

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.serving import http as ref_http  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import online  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.serving import http as port_http  # noqa: E402
from repro_torch.serving.http import EngineDriver, make_server  # noqa: E402


def _backbone():
    cfg = get_config("vicuna-7b", tiny=True).replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return cfg, model, params


def _serve_forever(srv):
    th = threading.Thread(target=srv.serve_forever,
                          kwargs={"poll_interval": 0.05}, daemon=True)
    th.start()
    return th


def _close(srv, th):
    srv.shutdown()
    srv.server_close()
    srv.driver.stop(drain=True)
    th.join(timeout=30.0)


@pytest.fixture(scope="module")
def server():
    cfg, model, params = _backbone()
    state = online.init_trainer(model, torch.Generator().manual_seed(3))
    eng = ServingEngine(model, params, state, scheduler="continuous",
                        num_slots=4, max_new=32, buckets=(16,),
                        max_queue=64)
    srv = make_server("127.0.0.1", 0, eng, model_id="dvi-tiny",
                      default_max_new=8, request_timeout_s=120.0)
    th = _serve_forever(srv)
    yield srv, eng, cfg
    _close(srv, th)


def _get(srv, path):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                      timeout=60)
    conn.request("GET", path)
    r = conn.getresponse()
    return r.status, r.getheader("Content-Type"), r.read()


def _post(srv, body, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                      timeout=timeout)
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    return conn, conn.getresponse()


def _read_sse(resp):
    toks, finish = [], None
    while True:
        line = resp.readline()
        if not line:
            break
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        payload = line[len(b"data: "):]
        if payload == b"[DONE]":
            break
        obj = json.loads(payload)
        assert "error" not in obj, obj
        ch = obj["choices"][0]
        toks.extend(ch.get("token_ids") or [])
        if ch.get("finish_reason"):
            finish = ch["finish_reason"]
    return toks, finish


def _prompt(cfg, seed=0, n=12):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(2, cfg.vocab_size, n)]


def test_routes(server):
    srv, eng, cfg = server
    st, ct, body = _get(srv, "/healthz")
    assert st == 200 and json.loads(body)["status"] == "ok"
    st, ct, body = _get(srv, "/v1/models")
    assert st == 200
    assert json.loads(body)["data"][0]["id"] == "dvi-tiny"
    st, ct, body = _get(srv, "/metrics")
    assert st == 200 and ct.startswith("text/plain")
    text = body.decode()
    assert "dvi_serving_submitted_total" in text
    assert "dvi_serving_requests_by_tenant" in text
    st, _, _ = _get(srv, "/nope")
    assert st == 404


def test_bad_request_is_400(server):
    srv, eng, cfg = server
    for bad in ({"prompt": []}, {"prompt": "not ints"},
                {"prompt": [1, True, 3]}, {}):
        _, r = _post(srv, bad)
        assert r.status == 400, bad
        assert json.loads(r.read())["error"]["type"] \
            == "invalid_request_error"


def test_sse_stream_matches_blocking_and_engine_direct(server):
    srv, eng, cfg = server
    prompt = _prompt(cfg, seed=5)
    _, r = _post(srv, {"prompt": prompt, "max_tokens": 12})
    assert r.status == 200
    body = json.loads(r.read())
    blocking = body["choices"][0]["token_ids"]
    assert body["usage"]["completion_tokens"] == len(blocking)
    assert set(body["timings"]) == {"queue_wait_s", "prefill_s", "decode_s",
                                    "ttft_s", "e2e_s"}

    _, r = _post(srv, {"prompt": prompt, "max_tokens": 12, "stream": True})
    assert r.status == 200
    sse, finish = _read_sse(r)
    assert finish in ("stop", "length")
    assert sse == blocking               # same engine, same greedy stream

    # engine-direct via the driver: the committed stream is the SAME
    # regardless of transport (greedy streams are schedule-independent)
    drv: EngineDriver = srv.driver
    h = drv.submit(Request(uid=drv.next_uid(),
                           prompt=np.asarray(prompt, np.int32),
                           max_new=12))
    direct = [t for ch in h.deltas(timeout=120.0) for t in ch]
    assert direct == sse


def test_text_field_roundtrips_token_ids(server):
    srv, eng, cfg = server
    prompt = _prompt(cfg, seed=6)
    _, r = _post(srv, {"prompt": prompt, "max_tokens": 6, "stream": True})
    text = r.read().decode()
    joined = "".join(json.loads(line[6:])["choices"][0]["text"]
                     for line in text.splitlines()
                     if line.startswith("data: ")
                     and not line.startswith("data: [DONE]"))
    _, r = _post(srv, {"prompt": prompt, "max_tokens": 6})
    toks = json.loads(r.read())["choices"][0]["token_ids"]
    assert [int(t) for t in joined.split()] == toks


def test_client_disconnect_cancels_at_boundary(server):
    srv, eng, cfg = server
    drv = srv.driver
    before = drv.call(lambda: eng.stats["cancelled"])
    body = json.dumps({"prompt": _prompt(cfg, seed=7), "max_tokens": 32,
                       "stream": True}).encode()
    sk = socket.create_connection(("127.0.0.1", srv.server_address[1]),
                                  timeout=60)
    sk.sendall(b"POST /v1/completions HTTP/1.0\r\n"
               b"Content-Type: application/json\r\n"
               + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    buf = b""
    while b"token_ids" not in buf:        # first committed chunk arrived
        buf += sk.recv(4096)
    # RST on close so the server's next SSE write fails immediately
    sk.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                  struct.pack("ii", 1, 0))
    sk.close()
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if drv.call(lambda: eng.stats["cancelled"]) > before:
            break
        time.sleep(0.1)
    assert drv.call(lambda: eng.stats["cancelled"]) == before + 1
    # lane actually retired: engine drains back to idle
    while drv.call(lambda: eng.busy):
        time.sleep(0.05)
    assert drv.call(lambda: sum(s is not None for s in eng._slots)) == 0


def test_backpressure_returns_429(server):
    srv, eng, cfg = server
    drv = srv.driver
    while drv.call(lambda: eng.busy):     # start from an idle engine
        time.sleep(0.05)
    drv.pause()                           # freeze stepping: queue can't drain
    try:
        drv.call(lambda: setattr(eng._tq, "max_queue", 2))
        conns, got429 = [], 0
        for i in range(4):
            conn, r = _post(srv, {"prompt": _prompt(cfg, seed=10 + i),
                                  "max_tokens": 4, "stream": True})
            if r.status == 429:
                got429 += 1
                err = json.loads(r.read())["error"]
                assert err["type"] == "rate_limit_exceeded"
            else:
                assert r.status == 200
                conns.append((conn, r))
        assert got429 == 2                # bound 2: requests 3+4 rejected
    finally:
        drv.call(lambda: setattr(eng._tq, "max_queue", 64))
        drv.resume()
    for conn, r in conns:                 # accepted ones still complete
        toks, finish = _read_sse(r)
        assert finish in ("stop", "length") and toks
    _, _, body = _get(srv, "/metrics")    # rejections surface in telemetry
    line = next(l for l in body.decode().splitlines()
                if l.startswith("dvi_serving_rejected_total"))
    assert float(line.split()[-1]) >= 2


def test_payload_and_prompt_parsers_match_the_reference():
    for tokens, finish in (([], "stop"), ([12, 7], None), ([3], "length"),
                           (np.asarray([5, 1], np.int32), "cancelled")):
        assert port_http._chunk_payload("cmpl-3", "m", tokens, finish) == \
            ref_http._chunk_payload("cmpl-3", "m", tokens, finish)
    for raw in ([3, 17, 99], "3 17 99", " 4  5 "):
        np.testing.assert_array_equal(port_http._parse_prompt(raw),
                                      ref_http._parse_prompt(raw))
        assert port_http._parse_prompt(raw).dtype == np.int32
    for bad in ([], "not ints", [1, True, 3], None, [1.5], {}):
        with pytest.raises(ValueError) as ep:
            port_http._parse_prompt(bad)
        with pytest.raises(ValueError) as er:
            ref_http._parse_prompt(bad)
        assert str(ep.value) == str(er.value)


def test_prefix_cache_sse_matches_engine_direct():
    """A server over the paged prefix-cached engine: SSE streams of
    requests that share a system prompt (two repeated exactly) equal the
    engine called directly without the prefix cache; hits and copies on
    write happen and the counters reconcile."""
    cfg, model, params = _backbone()
    kw = dict(scheduler="continuous", num_slots=4, max_new=8, cache_len=40, kv_pages=48,
              kv_page_size=4, prefill_chunk=4, sync_every=2)
    eng = ServingEngine(model, params, online.init_trainer(model, torch.Generator().manual_seed(3)),
                        prefix_cache=True, **kw)
    srv = make_server("127.0.0.1", 0, eng, model_id="dvi-tiny", default_max_new=8,
                      request_timeout_s=120.0)
    srv.driver.call(eng.warmup)
    th = _serve_forever(srv)
    try:
        rng = np.random.default_rng(1)
        sysp = [int(t) for t in rng.integers(2, cfg.vocab_size, 10)]
        prompts = [sysp + [int(t) for t in rng.integers(2, cfg.vocab_size, 1 + i % 4)]
                   for i in range(6)]
        prompts += [prompts[1], prompts[3]]
        got = {}
        for i, prompt in enumerate(prompts):       # one at a time: later ones hit
            _, r = _post(srv, {"prompt": prompt, "max_tokens": 8, "stream": True})
            got[i], finish = _read_sse(r)
            assert finish in ("stop", "length")
        stats = srv.driver.call(lambda: dict(eng.stats.items()))
    finally:
        _close(srv, th)
    assert stats["prefix_hits"] > 0 and stats["prefix_cow_copies"] > 0
    assert stats["prefix_hits"] + stats["prefix_misses"] == stats["prefix_lookups"]
    direct = ServingEngine(model, params,
                           online.init_trainer(model, torch.Generator().manual_seed(3)), **kw)
    hs = {i: direct.submit_request(Request(uid=i, prompt=np.asarray(p, np.int32), max_new=8))
          for i, p in enumerate(prompts)}
    direct.run()
    assert got == {i: [int(t) for t in h.tokens()] for i, h in hs.items()}
