"""The port's HTTP server, coalescing batcher and main_serve on the CPU,
against the JAX package's: the mirror of tests/test_serve.py's
TestHTTPServer, TestCoalescingBatcher, TestHTTPBodyLimits and
TestBatcherWorkerResilience. The JAX make_server around the JAX Predictor
and the port's around the port's Predictor, on the same weights
(``state_dict_from_jax``), get the same requests and must answer with the
same ``dos`` (atol = rtol = 1e-4, as for the whole model in
tests/test_torch_serve.py), the same ids and the same status codes; the
behaviours that need no model run against both implementations. Small
phDOS model: hidden 32, 2 processors, 1 layer a stack."""

import http.client
import io
import json
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from dostransformer_tpu import serve_batch as jserve_batch  # noqa: E402
from dostransformer_tpu import serve_http as jserve_http  # noqa: E402
from dostransformer_tpu.data import collate as jcollate  # noqa: E402
from dostransformer_tpu.data import synthetic as jsyn  # noqa: E402
from dostransformer_tpu.data.graph import RequestError as JRequestError  # noqa: E402
from dostransformer_tpu.models import DOSTransformerPhDOS as JModel  # noqa: E402
from dostransformer_tpu.serve import Predictor as JPredictor  # noqa: E402
from dostransformer_tpu_torch import serve_batch, serve_http  # noqa: E402
from dostransformer_tpu_torch.cli import main_serve  # noqa: E402
from dostransformer_tpu_torch.data.graph import GraphSample, RequestError  # noqa: E402
from dostransformer_tpu_torch.data.io import save_samples  # noqa: E402
from dostransformer_tpu_torch.models.import_torch import state_dict_from_jax  # noqa: E402
from dostransformer_tpu_torch.serve import Predictor  # noqa: E402

H, LAYERS, T_LAYERS = 32, 2, 1
TOL = dict(rtol=1e-4, atol=1e-4)
# (make_server, CoalescingBatcher, RequestError) of each implementation
IMPLS = {"jax": (jserve_http.make_server, jserve_batch.CoalescingBatcher,
                 JRequestError),
         "port": (serve_http.make_server, serve_batch.CoalescingBatcher,
                  RequestError)}


def _port(samples):
    return [GraphSample(**vars(s)) for s in samples]


def _body(samples) -> bytes:
    buf = io.BytesIO()
    save_samples(buf, _port(samples))
    return buf.getvalue()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX Predictor, the port's on the same weights (CPU), and the
    state_dict's path."""
    samples = jsyn.synthetic_phdos_samples(4, seed=15)
    jm = JModel(layers=LAYERS, t_layers=T_LAYERS, hidden=H)
    params = jm.init(jax.random.PRNGKey(0), jcollate(samples))
    path = tmp_path_factory.mktemp("w") / "phdos.pt"
    torch.save(state_dict_from_jax(params, task="phdos"), path)
    port = Predictor.from_torch(path, task="phdos",
                                example=_port(samples)[0], layers=LAYERS,
                                t_layers=T_LAYERS, hidden=H, batch_size=4,
                                device="cpu")
    return JPredictor(jm, params["params"], batch_size=4), port, path


class _Serving:
    """A server on an ephemeral port, serving on a thread."""

    def __init__(self, server):
        self.server = server
        self.port = server.server_address[1]
        self.thread = threading.Thread(target=server.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)

    def post(self, path, body, length=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=120)
        if length is None:
            conn.request("POST", path, body=body,
                         headers={"Content-Type": "application/octet-stream"})
        else:  # a declared length, no body
            conn.putrequest("POST", path)
            conn.putheader("Content-Length", length)
            conn.endheaders()
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, data

    def get(self, path):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=30)
        conn.request("GET", path)
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, data


class TestHTTPServer:
    def test_predict_endpoint_matches_direct(self, weights):
        """POST /predict (samples npz in, dos npz out) on both servers: the
        same spectra and ids, each its own predictor's direct predict; the
        same /healthz and the same 400 and 404."""
        jpred, port, _ = weights
        samples = jsyn.synthetic_phdos_samples(10, seed=15)
        body = _body(samples)
        found = {}
        for name, pred in (("jax", jpred), ("port", port)):
            with _Serving(IMPLS[name][0](pred, port=0)) as srv:
                status, health = srv.get("/healthz")
                assert status == 200
                assert json.loads(health) == {"status": "ok", "batch_size": 4}
                status, data = srv.post("/predict", body)
                assert status == 200, data
                with np.load(io.BytesIO(data)) as z:
                    found[name] = {k: z[k] for k in z.files}
                assert srv.post("/predict", b"not an npz")[0] == 400
                assert srv.get("/nope")[0] == 404
                assert srv.post("/nope", b"")[0] == 404
        np.testing.assert_allclose(found["port"]["dos"],
                                   port.predict(_port(samples)),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(found["port"]["dos"], found["jax"]["dos"],
                                   **TOL)
        for key in ("sample_id", "mp_id"):
            assert list(found["port"][key]) == list(found["jax"][key])

    @pytest.mark.parametrize("impl", ["jax", "port"])
    def test_server_error_statuses(self, impl):
        """Client input errors (the serving path's RequestError) map to 400;
        a plain ValueError and anything else are server faults, 500."""
        make_server, _, request_error = IMPLS[impl]
        body = _body(jsyn.synthetic_phdos_samples(2, seed=17))

        class Boom:
            batch_size = 4

            def predict(self, samples):
                raise RuntimeError("backend disconnected")

        class Picky(Boom):
            def predict(self, samples):
                raise request_error("request exceeds the shape envelope")

        class Drifted(Boom):
            def predict(self, samples):
                raise ValueError("Shape mismatch for args")

        for pred, code, text in ((Boom(), 500, b"backend disconnected"),
                                 (Picky(), 400, b"shape envelope"),
                                 (Drifted(), 500, b"Shape mismatch")):
            with _Serving(make_server(pred, port=0)) as srv:
                status, data = srv.post("/predict", body)
            assert status == code and text in data

    def test_cli_builds_server_from_artifact(self, weights, tmp_path):
        """main_serve --from_exported builds a working endpoint around an
        ExportedPredictor (no model flags): the artifact's predictions, and
        the JAX Predictor's within the tolerance."""
        jpred, port, _ = weights
        samples = jsyn.synthetic_phdos_samples(6, seed=16)
        port.export(str(tmp_path / "artifact"), _port(samples))
        server = main_serve.build_server(
            ["--from_exported", str(tmp_path / "artifact"), "--port", "0",
             "--device", "cpu"])
        with _Serving(server) as srv:
            status, data = srv.post("/predict", _body(samples))
        assert status == 200, data
        with np.load(io.BytesIO(data)) as z:
            dos = z["dos"]
        np.testing.assert_array_equal(dos, server.predictor.predict(
            _port(samples)))
        np.testing.assert_allclose(dos, jpred.predict(samples), **TOL)

    @pytest.mark.parametrize("coalesce", ["0", "5"])
    def test_cli_builds_server_from_weights(self, weights, tmp_path,
                                            coalesce):
        """main_serve --torch_state_dict (the port's flags, on the CPU)
        against the JAX main_serve's server on the same weights."""
        from dostransformer_tpu.cli import main_serve as jmain_serve

        jpred, _, path = weights
        samples = jsyn.synthetic_phdos_samples(7, seed=18)
        (tmp_path / "ex.npz").write_bytes(_body(samples))
        shape = ["--task", "phdos", "--torch_state_dict", str(path),
                 "--example", str(tmp_path / "ex.npz"), "--layers",
                 str(LAYERS), "--transformer", str(T_LAYERS), "--hidden",
                 str(H), "--batch_size", "4", "--port", "0", "--coalesce_ms",
                 coalesce]
        found = {}
        for name, build in (("jax", jmain_serve.build_server),
                            ("port", main_serve.build_server)):
            more = ["--device", "cpu"] if name == "port" else []
            with _Serving(build([*shape, *more])) as srv:
                status, data = srv.post("/predict", _body(samples))
                assert status == 200, data
                assert srv.post("/predict", b"")[0] == 400
            with np.load(io.BytesIO(data)) as z:
                found[name] = z["dos"]
        np.testing.assert_allclose(found["port"], found["jax"], **TOL)
        np.testing.assert_allclose(found["port"], jpred.predict(samples),
                                   **TOL)

    @pytest.mark.parametrize("argv,message", [
        (["--data_parallel", "--from_exported", "a"], "queue 1 item 9"),
        (["--from_exported", "a", "--torch_state_dict", "w.pt"],
         "exactly one of"),
        (["--from_exported", "a", "--checkpoint_state", "best"],
         "--checkpoint_state"),
        (["--task", "phdos", "--checkpoint_dir", "c"], "--example"),
    ])
    def test_cli_refuses(self, argv, message, capsys):
        with pytest.raises(SystemExit) as exc:
            main_serve.build_server([*argv, "--device", "cpu"])
        assert exc.value.code == 2
        assert message in capsys.readouterr().err

    def test_cli_refuses_a_job_of_several_processes(self, monkeypatch,
                                                    capsys):
        monkeypatch.setenv("WORLD_SIZE", "2")
        with pytest.raises(SystemExit):
            main_serve.build_server(["--from_exported", "a", "--device",
                                     "cpu"])
        assert "multi-process HTTP serving" in capsys.readouterr().err

    def test_cli_runs_on_the_card_by_default(self, monkeypatch, capsys):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit):
            main_serve.build_server(["--from_exported", "a"])
        assert "--device cpu" in capsys.readouterr().err


class _Fake:
    """Records every coalesced call; 'predicts' each int sample as its own
    value so per-request result slicing is checkable exactly."""

    batch_size = 4

    def __init__(self):
        self.calls = []

    def predict(self, samples):
        if any(s == "bad" for s in samples):
            raise ValueError("bad sample in request")
        self.calls.append(list(samples))
        return np.asarray(samples, np.float64)[:, None] * np.ones((1, 3))


@pytest.mark.parametrize("impl", ["jax", "port"])
class TestCoalescingBatcher:
    """Cross-request micro-batching, the same behaviour in both."""

    def test_concurrent_requests_coalesce_and_split_correctly(self, impl):
        fake = _Fake()
        batcher = IMPLS[impl][1](fake, max_delay_ms=1000.0)
        results = {}

        def worker(k):
            results[k] = batcher.predict([k * 10 + j for j in range(k + 1)])

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        batcher.close()
        batcher.close()  # idempotent
        for k in range(6):
            want = np.asarray([k * 10 + j for j in range(k + 1)],
                              np.float64)[:, None] * np.ones((1, 3))
            np.testing.assert_array_equal(results[k], want)
        assert 1 <= len(fake.calls) < 6
        assert sum(len(c) for c in fake.calls) == sum(range(1, 7))

    def test_error_isolation_retries_per_request(self, impl):
        fake = _Fake()
        batcher = IMPLS[impl][1](fake, max_delay_ms=500.0)
        results, errors = {}, {}

        def worker(k, payload):
            try:
                results[k] = batcher.predict(payload)
            except Exception as e:
                errors[k] = e

        threads = [threading.Thread(target=worker, args=(0, [1, 2])),
                   threading.Thread(target=worker, args=(1, ["bad"])),
                   threading.Thread(target=worker, args=(2, [3]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        batcher.close()
        assert isinstance(errors[1], ValueError)
        np.testing.assert_array_equal(results[0][:, 0], [1.0, 2.0])
        np.testing.assert_array_equal(results[2][:, 0], [3.0])
        assert 0 not in errors and 2 not in errors

    def test_empty_request_raises_without_enqueue(self, impl):
        fake = _Fake()
        batcher = IMPLS[impl][1](fake, max_delay_ms=1.0)
        with pytest.raises(IMPLS[impl][2], match="empty request"):
            batcher.predict([])
        batcher.close()
        assert fake.calls == []

    def test_max_samples_bounds_one_dispatch(self, impl):
        fake = _Fake()
        batcher = IMPLS[impl][1](fake, max_delay_ms=1000.0, max_samples=4)
        results = {}

        def worker(k):
            results[k] = batcher.predict([k * 10 + j for j in range(3)])

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        batcher.close()
        assert len(results) == 4
        assert all(len(c) <= 6 for c in fake.calls)  # 3 + 3 crosses the cap
        assert len(fake.calls) >= 2

    def test_predict_after_close_raises(self, impl):
        batcher = IMPLS[impl][1](_Fake(), max_delay_ms=1.0)
        batcher.close()
        with pytest.raises(RuntimeError, match="closed"):
            batcher.predict([1])


def test_http_coalescing_matches_direct(weights):
    """make_server(coalesce_ms=...) serves concurrent POSTs through one
    batcher; every client gets exactly its own rows back: the port's within
    the tolerance of the JAX Predictor's answer for all the samples."""
    jpred, port, _ = weights
    all_samples = jsyn.synthetic_phdos_samples(12, seed=31)
    ref = jpred.predict(all_samples)
    chunks = [all_samples[0:3], all_samples[3:8], all_samples[8:12]]
    statuses, outs = {}, {}
    with _Serving(serve_http.make_server(port, port=0,
                                         coalesce_ms=200.0)) as srv:
        def client(k):
            statuses[k], data = srv.post("/predict", _body(chunks[k]))
            outs[k] = np.load(io.BytesIO(data))["dos"]

        cts = [threading.Thread(target=client, args=(k,)) for k in range(3)]
        for ct in cts:
            ct.start()
        for ct in cts:
            ct.join(timeout=120)
    lo = 0
    for k, chunk in enumerate(chunks):
        assert statuses[k] == 200
        np.testing.assert_allclose(outs[k], ref[lo: lo + len(chunk)], **TOL)
        lo += len(chunk)


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_oversized_and_invalid_content_length(impl):
    """Over-limit bodies get 413 before any read; a declared negative length
    gets 400 (TestHTTPBodyLimits)."""

    class Never:
        batch_size = 4

        def predict(self, samples):  # pragma: no cover
            raise AssertionError("must not be reached")

    with _Serving(IMPLS[impl][0](Never(), port=0, max_body_mb=1)) as srv:
        assert srv.post("/predict", None, length=str(2 << 20))[0] == 413
        assert srv.post("/predict", None, length="-5")[0] == 400


@pytest.mark.parametrize("impl", ["jax", "port"])
class TestBatcherWorkerResilience:
    def test_worker_survives_success_path_exceptions(self, impl):
        """An exception escaping the split path fails THAT request and
        leaves the worker alive."""

        class Flaky:
            batch_size = 4

            def __init__(self):
                self.bad = True

            def predict(self, samples):
                if self.bad:
                    return None  # slicing None raises outside the retry
                return np.ones((len(samples), 3))

        flaky = Flaky()
        batcher = IMPLS[impl][1](flaky, max_delay_ms=1.0)
        try:
            with pytest.raises(TypeError):
                batcher.predict([1, 2])
            flaky.bad = False  # the SAME worker must still be serving
            assert batcher.predict([1, 2, 3]).shape == (3, 3)
        finally:
            batcher.close()

    def test_results_are_copies_not_views(self, impl):
        class Echo:
            batch_size = 4

            def predict(self, samples):
                return np.asarray(samples, np.float64)[:, None] * np.ones(
                    (1, 3))

        batcher = IMPLS[impl][1](Echo(), max_delay_ms=50.0)
        try:
            results = {}

            def call(name, samples):
                results[name] = batcher.predict(samples)

            ts = [threading.Thread(target=call, args=("a", [1.0, 2.0])),
                  threading.Thread(target=call, args=("b", [3.0]))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
            assert results["a"].base is None and results["b"].base is None
            results["a"][:] = -1.0  # must not touch b's rows
            np.testing.assert_array_equal(results["b"], np.full((1, 3), 3.0))
        finally:
            batcher.close()
