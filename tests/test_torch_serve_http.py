"""The port's HTTP server (birdnet_tpu_torch/serve/server.py) on the CPU,
against the JAX package's: every endpoint and body form gets the same
request on both servers, and the answers agree field by field (the same
status, species, indices, labels, error names and messages; confidences and
embeddings within 1e-4, range scores within 1e-6; the fields in
``_torch_serve_common.MAY_DIFFER`` are not compared)."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_serve_common import (  # noqa: E402
    LABELS10,
    LABELS12,
    RANGE_TOL,
    assert_same,
    both,
    call,
    classifiers,
    i16,
    range_filters,
    save_models,
    segment,
    serving,
    serving_both,
    wav_bytes,
)
from birdnet_tpu.errors import RangeFilterInferenceError as JRangeError  # noqa: E402
from birdnet_tpu.serve import make_server as j_make_server  # noqa: E402
from birdnet_tpu_torch.errors import RangeFilterInferenceError as TRangeError  # noqa: E402
from birdnet_tpu_torch.serve import make_server as t_make_server  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

LOCATION = "lat=42.5&lon=-76.4&date=06-15"


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return save_models(tmp_path_factory.mktemp("torch_serve_http"))


@pytest.fixture(scope="module")
def v24(paths):
    return classifiers(paths["v24"], LABELS10)


@pytest.fixture(scope="module")
def servers(paths, v24):
    """The two packages' servers over tiny v2.4 with the meta model's
    range filter, max_batch 8."""
    with serving_both(*v24, max_batch=8,
                      range_filter=range_filters(paths["meta"], LABELS10)) as s:
        yield s


@pytest.fixture(scope="module")
def perch_servers(paths):
    with serving_both(*classifiers(paths["perch"], LABELS12), max_batch=4) as s:
        yield s


def _seg(clf, seed):
    return segment(clf.config.sample_count, seed)


# -- GET ---------------------------------------------------------------------


@pytest.mark.parametrize("route", ["/v1/health", "/v1/info", "/v1/labels", "/v1/nope"])
def test_get_routes_match_jax(servers, route):
    status, body = both(servers, route)
    assert status == (404 if route == "/v1/nope" else 200)
    if route == "/v1/health":
        assert body["status"] == "ok" and body["device"] == "cpu"
    if route == "/v1/info":
        assert body["max_batch"] == 8 and body["species_allowed"] is None
    if route == "/v1/labels":
        assert body["labels"] == LABELS10


def test_metrics_match_jax(servers, v24):
    seg = i16(_seg(v24[0], 1)).tobytes()
    before = {k: call(b, "/v1/metrics")[1] for k, (b, _) in servers.items()}
    both(servers, "/v1/predict", seg)
    both(servers, "/v1/predict", np.zeros(10, "<i2").tobytes())
    after = {k: call(b, "/v1/metrics")[1] for k, (b, _) in servers.items()}
    assert after["torch"].keys() == after["jax"].keys()
    for k in ("requests_total", "segments_total", "errors_total", "rejected_total",
              "analyses_total", "analyze_segments_total"):
        assert (after["torch"][k] - before["torch"][k]) == (after["jax"][k] - before["jax"][k]), k
    assert after["torch"]["requests_total"] - before["torch"]["requests_total"] == 1
    assert after["torch"]["queue_depth"] == 0


def test_metrics_prometheus_match_jax(servers):
    texts = {k: call(b, "/v1/metrics?format=prometheus") for k, (b, _) in servers.items()}
    for status, _, r in texts.values():
        assert status == 200 and r.getheader("Content-Type").startswith("text/plain")
    names = {k: {ln.split()[0] for ln in t.splitlines() if ln and not ln.startswith("#")}
             for k, (_, t, _) in texts.items()}
    assert names["torch"] == names["jax"]
    assert "birdnet_latency_p50_seconds" in names["torch"]


def test_server_header_names_the_port(servers):
    _, _, r = call(servers["torch"][0], "/v1/health")
    assert r.getheader("Server").startswith("birdnet-tpu-torch-serve/")


# -- /v1/predict ---------------------------------------------------------------


@pytest.mark.parametrize("form", ["i16", "f32", "json_samples", "json_pcm16"])
def test_predict_body_forms_match_jax(servers, v24, form):
    import base64
    import json

    seg = _seg(v24[0], {"i16": 0, "f32": 7, "json_samples": 3, "json_pcm16": 4}[form])
    if form == "i16":
        status, body = both(servers, "/v1/predict", i16(seg).tobytes())
        want = v24[0].predict(i16(seg).astype(np.float32) / 32768.0)
    elif form == "f32":
        status, body = both(servers, "/v1/predict?dtype=f32", seg.astype("<f4").tobytes())
        want = v24[0].predict(seg)
    elif form == "json_samples":
        status, body = both(servers, "/v1/predict", json.dumps({"samples": seg.tolist()}).encode(),
                            content_type="application/json")
        want = v24[0].predict(seg)
    else:
        payload = {"pcm16_b64": base64.b64encode(i16(seg).tobytes()).decode()}
        status, body = both(servers, "/v1/predict", json.dumps(payload).encode(),
                            content_type="application/json")
        want = v24[0].predict(i16(seg).astype(np.float32) / 32768.0)
    assert status == 200 and body["model_type"] == "BIRDNET_V24"
    assert [p["index"] for p in body["predictions"]] == [p.index for p in want.predictions]
    np.testing.assert_allclose([p["confidence"] for p in body["predictions"]],
                               [p.confidence for p in want.predictions], rtol=0, atol=1e-5)


def test_predict_per_request_species(servers, v24):
    seg = i16(_seg(v24[0], 0)).tobytes()
    status, body = both(servers, "/v1/predict?species=species_2,species_6", seg)
    assert status == 200
    assert {p["species"] for p in body["predictions"]} == {"species_2", "species_6"}
    status, body = both(servers, "/v1/predict?species=not_a_bird", seg)
    assert status == 400 and "species" in body["message"]


def test_predict_min_confidence(servers, v24):
    seg = _seg(v24[0], 5).astype("<f4").tobytes()
    status, body = both(servers, "/v1/predict?min_confidence=1.1&dtype=f32", seg)
    assert status == 200 and body["predictions"] == []
    status, body = both(servers, "/v1/predict?min_confidence=0.0&dtype=f32", seg)
    assert len(body["predictions"]) == 3


def test_predict_embeddings_flag_on_a_model_without_them(servers, v24):
    status, body = both(servers, "/v1/predict?embeddings=1", i16(_seg(v24[0], 6)).tobytes())
    assert status == 200 and "embeddings_b64" not in body


def test_perch_predict_with_embeddings(perch_servers):
    seg = i16(segment(160_000, 8)).tobytes()
    status, body = both(perch_servers, "/v1/predict?embeddings=1", seg)
    assert status == 200 and body["model_type"] == "PERCH_V2" and body["embedding_dim"] == 48


def test_concurrent_predicts_match_jax(servers, v24):
    """Twelve threads post at once to each server; every answer equals the
    JAX server's for the same segment."""
    segs = [i16(_seg(v24[0], 100 + i)).tobytes() for i in range(12)]
    out = {k: [None] * len(segs) for k in servers}

    def hit(name, i):
        out[name][i] = call(servers[name][0], "/v1/predict", segs[i])[:2]

    threads = [threading.Thread(target=hit, args=(name, i)) for name in servers
               for i in range(len(segs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    for got, want in zip(out["torch"], out["jax"]):
        assert got[0] == want[0] == 200
        assert_same(got[1], want[1])


# -- errors ----------------------------------------------------------------------


@pytest.mark.parametrize("path,body,ctype", [
    ("/v1/predict", np.zeros(100, "<i2").tobytes(), None),              # InputSizeError
    ("/v1/predict?dtype=f32&min_confidence=abc", b"\0" * 4, None),      # BadRequest
    ("/v1/predict?dtype=f32&timeout_s=xyz", b"\0" * 4, None),
    ("/v1/predict?dtype=i8", b"\0\0", None),
    ("/v1/predict", b"\0\0\0", None),                                   # odd i16
    ("/v1/predict", b"{not json", "application/json"),
    ("/v1/predict", b"{}", "application/json"),
    ("/v1/predict", b"", None),                                         # empty body
    ("/v1/predictt", b"\0\0", None),                                    # 404
    ("/v1/analyze?rate=notanumber", b"\0\0", None),
    ("/v1/analyze", np.zeros(100, "<i2").tobytes(), None),              # needs rate
    ("/v1/analyze?rate=8000", np.zeros(1000, "<i2").tobytes(), None),   # AudioFormatError
    ("/v1/analyze?rate=48000&overlap=99", b"\0\0", None),
    ("/v1/embed?rate=48000", np.zeros(144000, "<i2").tobytes(), None),  # no embeddings
    ("/v1/predict?dtype=f32&lat=1", b"\0" * 4, None),                   # lat without lon
    ("/v1/predict?dtype=f32&lat=1&lon=2&date=0615", b"\0" * 4, None),
])
def test_errors_match_jax(servers, path, body, ctype):
    kwargs = {"content_type": ctype} if ctype else {}
    status, answer = both(servers, path, body, **kwargs)
    assert status in (400, 404)
    assert set(answer) == {"error", "message"}


@pytest.mark.parametrize("route", ["/v1/rangefilter", "/v1/rangefilter?lat=95&lon=0",
                                   "/v1/rangefilter?lat=1&lon=2&date=13-40"])
def test_rangefilter_errors_match_jax(servers, route):
    status, answer = both(servers, route)
    assert status == 400


def test_location_without_meta_model_is_400(v24):
    with serving_both(*v24, max_batch=4) as s:
        status, body = both(s, "/v1/predict?dtype=f32&lat=1&lon=2",
                            _seg(v24[0], 1).astype("<f4").tobytes())
        assert status == 400 and "meta model" in body["message"]
        status, body = both(s, "/v1/embed?rate=48000&overlap=99", b"\0\0")
        assert status == 400


def test_body_too_large_is_413(servers):
    """A Content-Length above the 1 GiB limit is refused before the body is
    read."""
    import http.client
    import json
    import urllib.parse

    answers = {}
    for name, (base, _) in servers.items():
        conn = http.client.HTTPConnection(urllib.parse.urlparse(base).netloc, timeout=60)
        conn.putrequest("POST", "/v1/predict")
        conn.putheader("Content-Type", "application/octet-stream")
        conn.putheader("Content-Length", str((1 << 30) + 2))
        conn.endheaders()
        r = conn.getresponse()
        answers[name] = (r.status, json.loads(r.read().decode()))
        conn.close()
    assert answers["torch"] == answers["jax"]
    assert answers["torch"][0] == 413 and answers["torch"][1]["error"] == "PayloadTooLarge"


def test_queue_full_is_503(servers, v24):
    seg = i16(_seg(v24[0], 2)).tobytes()
    for _, srv in servers.values():
        srv.state.batcher._max_queue = 0
    try:
        status, body = both(servers, "/v1/predict", seg)
    finally:
        for _, srv in servers.values():
            srv.state.batcher._max_queue = 4096
    assert status == 503 and body["error"] == "InferenceError" and "overloaded" in body["message"]


def test_analyze_admission_is_503_when_saturated(servers, v24):
    pcm = np.zeros(v24[0].config.sample_count, "<i2").tobytes()
    for _, srv in servers.values():
        srv.state.analyze_admission_timeout = 0.05
        for _ in range(4):
            srv.state.analyze_slots.acquire()
    try:
        status, body = both(servers, "/v1/analyze?rate=48000", pcm)
        assert status == 503 and body["error"] == "Overloaded"
        status, body = both(servers, "/v1/embed?rate=48000", pcm)
        assert status == 503 and body["error"] == "Overloaded"
    finally:
        for _, srv in servers.values():
            for _ in range(4):
                srv.state.analyze_slots.release()
            srv.state.analyze_admission_timeout = 120.0
    assert both(servers, "/v1/analyze?rate=48000", pcm)[0] == 200


def test_predict_timeout_is_504(servers, v24):
    status, body = both(servers, "/v1/predict?timeout_s=0", i16(_seg(v24[0], 9)).tobytes())
    assert status == 504 and body["error"] == "Timeout"


def test_rangefilter_fault_is_500(v24):
    """A meta-model fault is the server's, not the request's: 500, named."""

    def broken(error):
        class _Broken:
            threshold = 0.01

            def predict(self, lat, lon, month, day):
                raise error("device fault")

        return _Broken()

    with serving_both(*v24, max_batch=4,
                      range_filter=(broken(TRangeError), broken(JRangeError))) as s:
        status, body = both(s, "/v1/rangefilter?lat=10.0&lon=20.0")
        assert status == 500 and body["error"] == "RangeFilterInferenceError"
        status, body = both(s, "/v1/predict?dtype=f32&lat=10.0&lon=20.5",
                            _seg(v24[0], 6).astype("<f4").tobytes())
        assert status == 500 and body["error"] == "RangeFilterInferenceError"


def test_unread_body_does_not_corrupt_keepalive(servers):
    import http.client
    import urllib.parse

    conn = http.client.HTTPConnection(urllib.parse.urlparse(servers["torch"][0]).netloc,
                                      timeout=60)
    conn.request("POST", "/v1/predictt", body=np.zeros(1000, "<i2").tobytes(),
                 headers={"Content-Type": "application/octet-stream"})
    r = conn.getresponse()
    assert r.status == 404
    r.read()
    conn.request("GET", "/v1/health")
    r2 = conn.getresponse()
    assert r2.status == 200
    r2.read()
    conn.close()


# -- /v1/analyze and /v1/embed ---------------------------------------------------


def test_analyze_wav_matches_jax(servers, v24):
    cfg = v24[0].config
    pcm = (np.random.default_rng(11).standard_normal(cfg.sample_count * 3) * 3000).astype("<i2")
    status, body = both(servers, "/v1/analyze", wav_bytes(pcm, cfg.sample_rate))
    assert status == 200 and body["segments"] == 3
    direct = v24[0].analyze_samples(pcm)
    assert [d["start_time"] for d in body["detections"]] == [round(t, 3) for t, _ in direct]
    for det, (_, preds) in zip(body["detections"], direct):
        assert [p["index"] for p in det["predictions"]] == [p.index for p in preds]


def test_analyze_raw_pcm_options_match_jax(servers, v24):
    cfg = v24[0].config
    pcm = (np.random.default_rng(13).standard_normal(cfg.sample_count * 2) * 3000).astype("<i2")
    for query in ("", "&overlap=1.5", "&min_confidence=0.3", "&species=species_1,species_8"):
        status, body = both(servers, f"/v1/analyze?rate={cfg.sample_rate}{query}", pcm.tobytes())
        assert status == 200, query
        if "species" in query:
            emitted = {p["species"] for d in body["detections"] for p in d["predictions"]}
            assert emitted and emitted <= {"species_1", "species_8"}
    assert body["segments"] == 2


def test_analyze_resample_on_the_classifiers_device(servers, v24):
    """resample=1 converts a 24 kHz WAV on the classifier's device (the
    host here); the detections match the JAX server's."""
    cfg = v24[0].config
    pcm = (np.random.default_rng(14).standard_normal(cfg.sample_count) * 3000).astype("<i2")
    body = wav_bytes(pcm, 24_000)
    status, answer = both(servers, "/v1/analyze", body)
    assert status == 400 and answer["error"] == "AudioFormatError"
    status, answer = both(servers, "/v1/analyze?resample=1&min_confidence=0", body)
    assert status == 200 and answer["segments"] == 2


def test_embed_matches_jax(perch_servers):
    pcm = (np.random.default_rng(31).standard_normal(160_000 * 3) * 3000).astype("<i2")
    status, body = both(perch_servers, "/v1/embed?rate=32000", pcm.tobytes())
    assert status == 200 and body["segments"] == 3 and body["embedding_dim"] == 48
    status, body = both(perch_servers, "/v1/embed?overlap=2.5", wav_bytes(pcm, 32_000))
    assert status == 200 and body["segments"] == 6
    status, body = both(perch_servers, "/v1/embed?overlap=99", b"\0\0")
    assert status == 400 and "overlap" in body["message"]


def test_perch_analyze_matches_jax(perch_servers):
    pcm = (np.random.default_rng(32).standard_normal(160_000 * 2) * 3000).astype("<i2")
    status, body = both(perch_servers, "/v1/analyze?rate=32000", pcm.tobytes())
    assert status == 200 and body["segments"] == 2


# -- range filter ------------------------------------------------------------------


def test_rangefilter_scores_match_jax(servers):
    status, body = both(servers, f"/v1/rangefilter?{LOCATION}", tol=RANGE_TOL)
    assert status == 200 and body["count"] == len(body["scores"])
    status, body = both(servers, "/v1/rangefilter?lat=-33.9&lon=151.2&date=12-31", tol=RANGE_TOL)
    assert status == 200


@pytest.mark.parametrize("query", [LOCATION, "lat=10&lon=20&date=03-01&rerank=1"])
def test_predict_with_location_matches_jax(servers, v24, query):
    seg = _seg(v24[0], 42).astype("<f4").tobytes()
    status, body = both(servers, f"/v1/predict?dtype=f32&{query}", seg)
    assert status == 200


def test_analyze_with_location_matches_jax(servers, v24):
    cfg = v24[0].config
    pcm = (np.random.default_rng(9).standard_normal(cfg.sample_count) * 3000).astype("<i2")
    status, body = both(servers, f"/v1/analyze?rate={cfg.sample_rate}&{LOCATION}&rerank=1",
                        pcm.tobytes())
    assert status == 200


def test_species_restricted_server_matches_jax(v24):
    with serving_both(*v24, max_batch=4, species_allow={"species_1", "species_4"}) as s:
        status, body = both(s, "/v1/info")
        assert body["species_allowed"] == 2
        status, body = both(s, "/v1/predict?min_confidence=0", i16(_seg(v24[0], 12)).tobytes())
        assert {p["species"] for p in body["predictions"]} <= {"species_1", "species_4"}


# -- mixed traffic -------------------------------------------------------------------


@pytest.mark.parametrize("name", ["torch", "jax"])
def test_mixed_concurrent_traffic_no_5xx(servers, v24, name):
    """16 client threads fire a mix of predicts, analyzes, bad requests and
    metrics reads at one server: every answer has the right status, no
    device error is counted, and every queued segment ran."""
    base = servers[name][0]
    cfg = v24[0].config
    good = _seg(v24[0], 77).astype("<f4").tobytes()
    bad = np.zeros(10, "<f4").tobytes()
    pcm = np.zeros(cfg.sample_count, "<i2").tobytes()
    statuses, lock = [], threading.Lock()

    def worker(i):
        for j in range(4):
            kind = (i + j) % 4
            if kind == 0:
                s, want = call(base, "/v1/predict?dtype=f32", good)[0], 200
            elif kind == 1:
                s, want = call(base, "/v1/predict?dtype=f32", bad)[0], 400
            elif kind == 2:
                s, want = call(base, f"/v1/analyze?rate={cfg.sample_rate}", pcm)[0], 200
            else:
                s, want = call(base, "/v1/metrics")[0], 200
            with lock:
                statuses.append((kind, s, want))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    assert len(statuses) == 64
    for kind, got, want in statuses:
        assert got == want, (kind, got, want)
    m = call(base, "/v1/metrics")[1]
    assert m["errors_total"] == 0
    assert m["segments_total"] == m["requests_total"]


def test_make_server_defaults_match_jax(v24):
    """make_server on the port builds its state like the JAX package's:
    the same defaults, one batch context per worker (eager on the host)."""
    with serving(t_make_server, v24[0], workers=2) as (_, t_srv), \
            serving(j_make_server, v24[1], workers=2) as (_, j_srv):
        for srv in (t_srv, j_srv):
            assert srv.state.batcher.max_batch == 32
            assert len(srv.state.batcher._contexts) == 2
            assert srv.daemon_threads
        assert t_srv.state.batcher._contexts[0].graph is None  # the host: eager


def test_64_simultaneous_connections_are_all_served(servers, v24):
    """64 clients connect at the same moment: the port's server listens
    with a backlog that holds them all, and answers each. (The JAX
    package's server keeps socketserver's backlog of 5; under the same
    burst the kernel resets some of its connections.)"""
    t_srv, j_srv = servers["torch"][1], servers["jax"][1]
    assert j_srv.request_queue_size == 5
    assert t_srv.request_queue_size >= 64
    seg = i16(_seg(v24[0], 64)).tobytes()
    start = threading.Barrier(64)
    statuses, lock = [], threading.Lock()

    def hit():
        start.wait(timeout=60)
        status = call(servers["torch"][0], "/v1/predict", seg)[0]
        with lock:
            statuses.append(status)

    threads = [threading.Thread(target=hit) for _ in range(64)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert statuses == [200] * 64
