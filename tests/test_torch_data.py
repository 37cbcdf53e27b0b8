"""The PyTorch port's data layer against the JAX package: collation, the
synthetic generator, npz io and the serving loader give identical arrays
(exact equality: both are numpy on the host)."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from dostransformer_tpu.data import graph as jgraph  # noqa: E402
from dostransformer_tpu.data import io as jio  # noqa: E402
from dostransformer_tpu.data import synthetic as jsyn  # noqa: E402
from dostransformer_tpu.data.datasets import GraphLoader as JLoader  # noqa: E402
from dostransformer_tpu_torch.data import graph, io, synthetic  # noqa: E402
from dostransformer_tpu_torch.data.datasets import GraphLoader  # noqa: E402

FIELDS = [f.name for f in dataclasses.fields(graph.GraphBatch)]


def _port(samples):
    """JAX GraphSamples as the port's (same fields)."""
    return [graph.GraphSample(**dataclasses.asdict(s)) for s in samples]


def assert_batches_equal(jb, tb):
    for name in FIELDS:
        want, got = getattr(jb, name), getattr(tb, name)
        if want is None:
            assert got is None, name
            continue
        assert isinstance(got, torch.Tensor), name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
        assert got.numpy().dtype == np.asarray(want).dtype, name


def test_synthetic_edos_matches_jax():
    for kw in ({}, {"min_atoms": 3, "max_atoms": 6}):
        ours = synthetic.synthetic_edos_samples(4, seed=7, **kw)
        ref = jsyn.synthetic_edos_samples(4, seed=7, **kw)
        for a, b in zip(ours, ref):
            for f in dataclasses.fields(jgraph.GraphSample):
                va, vb = getattr(a, f.name), getattr(b, f.name)
                if isinstance(vb, np.ndarray):
                    np.testing.assert_array_equal(va, vb, err_msg=f.name)
                else:
                    assert va == vb, f.name


@pytest.mark.parametrize("kwargs", [
    {},                                          # buckets
    {"num_graphs": 5},                           # short batch: dummy graphs
    {"use_buckets": False},                      # exact shapes
    {"atoms_per_graph": 40, "edges_per_graph": 400, "num_graphs": 4},
])
def test_collate_matches_jax_numpy_collate(kwargs):
    samples = jsyn.synthetic_edos_samples(3, seed=11)
    jb = jgraph.collate(samples, numpy=True, **kwargs)
    assert_batches_equal(jb, graph.collate(_port(samples), **kwargs))


def test_collate_phdos_fields_match_jax():
    """edge_vec/edge_shift/node_z (the phDOS schema) pack like the JAX
    package's."""
    samples = jsyn.synthetic_phdos_samples(3, seed=12)
    jb = jgraph.collate(samples, numpy=True, num_graphs=4)
    assert_batches_equal(jb, graph.collate(_port(samples), num_graphs=4))


@pytest.mark.parametrize("case", ["empty", "num_graphs", "atoms", "edges",
                                  "schema", "width", "bins"])
def test_collate_request_errors(case):
    s = synthetic.synthetic_edos_samples(3, seed=3)
    kwargs = {}
    if case == "empty":
        s = []
    elif case == "num_graphs":
        kwargs = {"num_graphs": 2}
    elif case == "atoms":
        kwargs = {"atoms_per_graph": 2}
    elif case == "edges":
        kwargs = {"edges_per_graph": 1}
    elif case == "schema":
        s[1].glob = None
    elif case == "width":
        s[1].x = s[1].x[:, :10]
    else:
        s[2].y = s[2].y[:50]
    with pytest.raises(graph.RequestError):
        graph.collate(s, **kwargs)
    with pytest.raises(ValueError):  # the JAX package rejects it too
        jgraph.collate([jgraph.GraphSample(**dataclasses.asdict(x))
                        for x in s], numpy=True, **kwargs)


def test_bucket_size_matches_jax():
    for n in (0, 1, 7, 8, 9, 100, 128, 129, 300, 385, 1000):
        assert graph.bucket_size(n) == jgraph.bucket_size(n)


def test_npz_io_is_shared_with_jax(tmp_path):
    samples = synthetic.synthetic_edos_samples(3, seed=4)
    samples[0].y_max, samples[1].band_gap = 2.5, 0.7
    io.save_samples(tmp_path / "port.npz", samples)
    jio.save_samples(str(tmp_path / "jax.npz"),
                     [jgraph.GraphSample(**dataclasses.asdict(s))
                      for s in samples])
    for path in ("port.npz", "jax.npz"):
        ours = io.load_samples(tmp_path / path)
        ref = jio.load_samples(str(tmp_path / path))
        assert len(ours) == len(ref) == 3
        for a, b, orig in zip(ours, ref, samples):
            for f in dataclasses.fields(graph.GraphSample):
                va, vb = getattr(a, f.name), getattr(b, f.name)
                vo = getattr(orig, f.name)
                if isinstance(vo, np.ndarray):
                    np.testing.assert_array_equal(va, vo, err_msg=f.name)
                    np.testing.assert_array_equal(vb, vo, err_msg=f.name)
                else:
                    assert va == vb == vo, f.name


def test_loader_matches_jax_loader():
    samples = jsyn.synthetic_edos_samples(7, seed=5)
    ours = list(GraphLoader(_port(samples), batch_size=3))
    ref = list(JLoader(samples, batch_size=3, numpy=True))
    assert len(ours) == len(ref) == len(GraphLoader(_port(samples), 3)) == 3
    for jb, tb in zip(ref, ours):
        assert_batches_equal(jb, tb)
    assert ours[-1].graph_mask.tolist() == [1.0, 0.0, 0.0]
    with pytest.raises(graph.RequestError):
        GraphLoader([], batch_size=3)


def test_batch_to_keeps_every_field():
    b = graph.collate(synthetic.synthetic_edos_samples(2, seed=6))
    moved = b.to("cpu")
    assert_batches_equal(b, moved)
    assert moved.num_graphs == 2 and moved.atoms_per_graph == b.atoms_per_graph
    assert moved.edges_per_graph == b.edges_per_graph
