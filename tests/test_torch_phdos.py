"""The PyTorch port's phDOS slice against the JAX package on the CPU: the
segment-sum op and its plain version, the edge geometry, the scatter-mean
Processor, the whole DOSTransformerPhDOS forward, its gradients and 3 train
steps, weight import, synthetic data, splits, the neighbour list and CSV
featuriser, main_phdos and the phDOS Predictor. Small size: hidden 32, 2
processors, 1 transformer layer per stack; batches of 3 samples plus one
dummy graph; inputs from numpy with a seed; f32 on both sides. The JAX
Pallas kernels run in interpret mode (tests/conftest.py).

Tolerances, each stated where it is used: segment sums and one module
1e-5 (summation order only), geometry 1e-6 (elementwise), the whole model
1e-4 (f32 through ~10 layers of products summed in another order), whole-
model gradients 1e-4 of each tensor's largest element, 3 train steps: losses
rtol 1e-5 and params atol 1e-6; host data (samples, splits, neighbour lists,
featurised arrays) exact."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from dostransformer_tpu.cli.common import _write_results_line  # noqa: E402
from dostransformer_tpu.config import TrainConfig as JConfig  # noqa: E402
from dostransformer_tpu.config import crystal_system_id as jcrystal_id  # noqa: E402
from dostransformer_tpu.config import exp_get_name as jexp_get_name  # noqa: E402
from dostransformer_tpu.data import collate as jcollate  # noqa: E402
from dostransformer_tpu.data import datasets as jdatasets  # noqa: E402
from dostransformer_tpu.data import elements as jelements  # noqa: E402
from dostransformer_tpu.data import synthetic as jsyn  # noqa: E402
from dostransformer_tpu.data.featurize_phdos import (  # noqa: E402
    featurize_csv as jfeaturize_csv,
)
from dostransformer_tpu.data.neighbors import (  # noqa: E402
    neighbor_list_pbc as jneighbor_list_pbc,
)
from dostransformer_tpu.models import DOSTransformerPhDOS as JModel  # noqa: E402
from dostransformer_tpu.models.import_torch import (  # noqa: E402
    export_reference_state_dict,
)
from dostransformer_tpu.nn import modules as jmodules  # noqa: E402
from dostransformer_tpu.ops import geometry as jgeometry  # noqa: E402
from dostransformer_tpu.ops import segment as jseg  # noqa: E402
from dostransformer_tpu.serve import Predictor as JPredictor  # noqa: E402
from dostransformer_tpu.train import loss as jloss  # noqa: E402
from dostransformer_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from dostransformer_tpu.train.trainer import TrainState  # noqa: E402
from dostransformer_tpu_torch import config  # noqa: E402
from dostransformer_tpu_torch.cli import main_phdos, main_predict  # noqa: E402
from dostransformer_tpu_torch.data import (  # noqa: E402
    datasets,
    elements,
    graph,
    neighbors,
    synthetic,
)
from dostransformer_tpu_torch.data.featurize_phdos import featurize_csv  # noqa: E402
from dostransformer_tpu_torch.data.featurize_phdos import (  # noqa: E402
    main as featurize_main,
)
from dostransformer_tpu_torch.data.io import load_samples, save_samples  # noqa: E402
from dostransformer_tpu_torch.models.dostransformer import (  # noqa: E402
    DOSTransformerPhDOS,
)
from dostransformer_tpu_torch.models.import_torch import (  # noqa: E402
    load_reference_state_dict,
    state_dict_from_jax,
)
from dostransformer_tpu_torch.models.registry import build_model  # noqa: E402
from dostransformer_tpu_torch.nn.modules import NodeModel, Processor  # noqa: E402
from dostransformer_tpu_torch.ops import geometry, segment  # noqa: E402
from dostransformer_tpu_torch.serve import Predictor  # noqa: E402
from dostransformer_tpu_torch.train import loss  # noqa: E402
from dostransformer_tpu_torch.train.trainer import Trainer  # noqa: E402

H = 32
TOL = dict(rtol=1e-5, atol=1e-5)
GEOMETRY_TOL = dict(rtol=1e-6, atol=1e-6)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(samples):
    return [graph.GraphSample(**dataclasses.asdict(s)) for s in samples]


def _batches(seed=5):
    """3 synthetic phDOS samples plus one dummy graph, JAX and port."""
    samples = jsyn.synthetic_phdos_samples(3, seed=seed)
    return (jcollate(samples, num_graphs=4),
            graph.collate(_port(samples), num_graphs=4))


# --- the segment sum (kernel #6's plain version and op) -----------------


def _segment_inputs(seed, b, e, f, n):
    rng = np.random.RandomState(seed)
    w = (rng.rand(b, e) > 0.3).astype(np.float32)
    w[-1] = 0.0  # a dummy graph: no real rows
    data = rng.randn(b, e, f).astype(np.float32) * w[..., None]
    ids = rng.randint(-2, n + 2, (b, e)).astype(np.int32)  # some dropped
    return data, ids, w


@pytest.mark.parametrize("f", [1, 5, 130])
def test_segment_sum_matches_jax_pallas_kernel_and_segment_ops(f):
    """The plain version and the op on the CPU against JAX's Pallas
    segment_sum_pallas (interpret mode), graph by graph, and against its
    batched_segment_sum / batched_segment_mean; out-of-range ids (-2, -1,
    n, n+1) are dropped. Atol 1e-5 (summation order)."""
    n = 9
    data, ids, w = _segment_inputs(0, 3, 40, f, n)
    td, ti = torch.from_numpy(data), torch.from_numpy(ids)
    plain = segment.segment_sum_reference(td, ti, n)
    before = segment.batched_segment_sum.launches
    op = segment.batched_segment_sum(td, ti, n)
    assert segment.batched_segment_sum.launches == before  # no kernel ran
    assert torch.equal(op, plain)
    for g in range(3):
        want = jseg.segment_sum_pallas(jnp.asarray(data[g]),
                                       jnp.asarray(ids[g]), n)
        np.testing.assert_allclose(plain[g].numpy(), np.asarray(want), **TOL)
    want = jseg.batched_segment_sum(jnp.asarray(data), jnp.asarray(ids), n)
    np.testing.assert_allclose(op.numpy(), np.asarray(want), **TOL)
    want = jseg.batched_segment_mean(jnp.asarray(data), jnp.asarray(ids), n,
                                     jnp.asarray(w))
    got = segment.batched_segment_mean(td, ti, n, torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (B, E, F, N) -> the kernel's partition: the phDOS count (F = 1), a wide
# row, real crystals at F = 1 and 256, and ragged shapes; the card run holds
# the mirror equal to the library's dostpu_segment_sum_plan
@pytest.mark.parametrize("shape, plan", [
    ((8, 128, 1, 16), (1, 1, 256, 1)), ((8, 384, 256, 32), (4, 2, 64, 32)),
    ((8, 2048, 1, 64), (1, 1, 256, 1)), ((8, 2048, 256, 64), (4, 2, 32, 64)),
    ((2, 90, 300, 7), (4, 1, 16, 7)), ((2, 0, 4, 3), (4, 1, 1, 3)),
    ((1, 9, 1, 1), (1, 1, 256, 1)), ((3, 70, 3, 13), (1, 1, 16, 13)),
    ((1, 64, 4096, 4), (4, 4, 8, 4))])
def test_segment_sum_plan(shape, plan):
    got = segment.segment_sum_plan(*shape)
    assert (got["vec"], got["lanes"], got["slots"], got["segs"]) == plan
    tf = got["vec"] * got["lanes"]
    assert got["slots"] * got["segs"] * tf <= 24576  # 96 KB of row blocks
    assert got["lanes"] * got["slots"] <= 256


def _segment_sum_emulated(data, segment_ids, num_segments):
    """csrc/segment_sum.cu's arithmetic in plain torch: slot p of
    segment_sum_plan adds the rows of edges p, p + P, ... in index
    order into a private row block of its own, then a binary tree adds the
    slots' blocks (slot s + P / 2 into s, ...). Feature lanes and segment
    ranges split the work without touching the order of any sum; at F = 1
    the count kernel's 256 threads, each summing its edges for one segment,
    then the same tree, are the same arithmetic."""
    b, e, f = data.shape
    p = segment.segment_sum_plan(b, e, f, num_segments)["slots"]
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    ids = torch.where(valid, segment_ids, num_segments).long()  # a spare row
    priv = data.new_zeros((b, p, num_segments + 1, f))
    slot = torch.arange(p)
    batch = torch.arange(b)[:, None]
    for k in range(-(-e // p)):
        edges = k * p + slot
        live = edges < e
        ee = edges[live]
        priv[batch, slot[live][None], ids[:, ee]] += data[:, ee]
    while p > 1:
        p //= 2
        priv = priv[:, :p] + priv[:, p:2 * p]
    return priv[:, 0, :num_segments]


@pytest.mark.parametrize("shape", [(8, 128, 1, 16), (3, 40, 5, 9),
                                   (2, 90, 300, 7), (2, 17, 3, 5),
                                   (1, 9, 1, 1), (2, 2048, 1, 64)])
def test_segment_sum_kernel_arithmetic_emulated(shape):
    """The kernel's partition (edge slots in index order, private row
    blocks, a binary tree over the slots) emulated in plain torch against
    JAX's batched_segment_sum: exact on the 0/1 counts of the model's path,
    atol 1e-5 on real rows (summation order)."""
    b, e, f, n = shape
    data, ids, w = _segment_inputs(3, b, e, f, n)
    want = np.asarray(jseg.batched_segment_sum(jnp.asarray(data),
                                               jnp.asarray(ids), n))
    td, ti = torch.from_numpy(data), torch.from_numpy(ids)
    got = _segment_sum_emulated(td, ti, n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    count = torch.from_numpy(w)[..., None]
    assert torch.equal(_segment_sum_emulated(count, ti, n),
                       segment.segment_sum_reference(count, ti, n))


def test_segment_sum_gradient():
    """The op's backward gathers the upstream gradient at the ids (zero for
    dropped ids): against jax.vjp of batched_segment_sum (exact: a gather),
    and torch.autograd.gradcheck in f64."""
    n = 4
    data, ids, _ = _segment_inputs(1, 2, 11, 3, n)
    ti = torch.from_numpy(ids)
    g = np.random.RandomState(2).randn(2, n, 3).astype(np.float32)
    _, vjp = jax.vjp(lambda d: jseg.batched_segment_sum(d, jnp.asarray(ids), n),
                     jnp.asarray(data))
    (want,) = vjp(jnp.asarray(g))
    leaf = torch.from_numpy(data).requires_grad_()
    segment.batched_segment_sum(leaf, ti, n).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(leaf.grad.numpy(), np.asarray(want))
    leaf = torch.from_numpy(data).double().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda d: segment.batched_segment_sum(d, ti, n), (leaf,))


# --- geometry and the scatter-mean Processor -----------------------------


def test_edge_geometry_matches_jax():
    """SH l<=1 x smooth cutoff against JAX, atol 1e-6: zero vectors give
    [1, 0, 0, 0], lengths at or past r_max give 0; edge_vec takes no
    gradient."""
    rng = np.random.RandomState(3)
    vec = (rng.randn(3, 40, 3) * 2.5).astype(np.float32)
    vec[:, :3] = 0.0                # self-loops and pad edges
    vec[0, 3] = [4.0, 0.0, 0.0]     # exactly r_max
    vec[0, 4] = [0.0, -2.0, 0.0]    # r_max / 2: the cutoff's knee
    lengths = np.linalg.norm(vec, axis=-1)
    assert (lengths > 4.0).sum() > 10
    want = jgeometry.edge_geometry_phdos(jnp.asarray(vec), 4.0)
    leaf = torch.from_numpy(vec).requires_grad_()
    got = geometry.edge_geometry_phdos(leaf, 4.0)
    assert got.shape == (3, 40, 4) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEOMETRY_TOL)
    torch.testing.assert_close(got[:, :3], torch.tensor(
        [1.0, 0.0, 0.0, 0.0]).expand(3, 3, 4), rtol=0, atol=0)
    assert (got[torch.from_numpy(lengths >= 4.0)] == 0).all()
    x = torch.linspace(-0.5, 1.5, 41)
    np.testing.assert_allclose(geometry.smooth_cutoff(x).numpy(),
                               np.asarray(jgeometry.smooth_cutoff(
                                   jnp.asarray(x.numpy()))), **GEOMETRY_TOL)
    np.testing.assert_allclose(
        geometry.spherical_harmonics_l1(torch.from_numpy(vec)).numpy(),
        np.asarray(jgeometry.spherical_harmonics_l1(jnp.asarray(vec))),
        **GEOMETRY_TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_processor_mean_matches_jax(fused):
    """Processor(aggregation="mean") against JAX's with its fused Pallas
    kernel (interpret) and with its plain segment ops: pad edges stay out
    of both the sum and the count. Atol 1e-5."""
    jb, tb = _batches()
    rng = np.random.RandomState(2)
    x = rng.randn(4, jb.atoms_per_graph, H).astype(np.float32)
    e = rng.randn(4, jb.edges_per_graph, H).astype(np.float32)
    jm = jmodules.Processor(H, aggregation="mean", use_fused_mp=fused)
    args = (jnp.asarray(x), jb.senders, jb.receivers, jnp.asarray(e),
            jb.edge_mask)
    params = jm.init(jax.random.PRNGKey(3), *args)
    want = jm.apply(params, *args)
    tm = Processor(H, "mean")
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    got = tm(torch.from_numpy(x), tb.senders, tb.receivers,
             torch.from_numpy(e), tb.edge_mask)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    with pytest.raises(ValueError):
        NodeModel(H, "max")


# --- the whole model ----------------------------------------------------


@pytest.mark.parametrize("padding", ["mask", "ref"])
@pytest.mark.parametrize("kernels", [False, True],
                         ids=["jax_plain", "jax_pallas"])
def test_phdos_forward_matches_jax(padding, kernels):
    """All three outputs, against JAX run through its Pallas kernels
    (interpret mode) and through its plain jnp paths. Atol 1e-4."""
    jb, tb = _batches()
    jm = JModel(layers=2, t_layers=1, hidden=H, padding=padding,
                use_pallas=kernels, use_fused_mp=kernels)
    params = jm.init(jax.random.PRNGKey(0), jb)
    want = jm.apply(params, jb)
    tm = DOSTransformerPhDOS(layers=2, t_layers=1, hidden=H, padding=padding)
    tm.load_state_dict(state_dict_from_jax(params, task="phdos"), strict=True)
    with torch.inference_mode():
        got = tm(tb)
    a = tb.atoms_per_graph
    assert [tuple(g.shape) for g in got] == [(4, 51), (4, a, H), (4, 51)]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL)


def _train_batches(n_batches=3, seed=11):
    """n same-shape batches of 3 learnable samples + 1 dummy graph."""
    samples = jsyn.synthetic_phdos_learnable(3 * n_batches, seed=seed)
    a = graph.bucket_size(max(s.n_nodes for s in samples))
    e = graph.bucket_size(max(s.n_edges for s in samples))
    groups = [samples[3 * i: 3 * i + 3] for i in range(n_batches)]
    kw = dict(atoms_per_graph=a, edges_per_graph=e, num_graphs=4)
    return ([jcollate(g, **kw) for g in groups],
            [graph.collate(_port(g), **kw) for g in groups])


@pytest.fixture(scope="module")
def jax_model():
    jb, _ = _train_batches()
    jm = JModel(layers=2, t_layers=1, hidden=H, use_pallas=True,
                use_fused_mp=True)
    return jm, jax.jit(jm.init)(jax.random.PRNGKey(0), jb[0])["params"]


def _port_model(params):
    tm = DOSTransformerPhDOS(layers=2, t_layers=1, hidden=H)
    tm.load_state_dict(state_dict_from_jax(params, task="phdos"), strict=True)
    return tm


def _scaled_close(got: torch.Tensor, want: np.ndarray, rel: float, name):
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= rel * max(1.0, float(np.abs(want).max())), (name, err)


def test_phdos_gradients_match_jax_grad(jax_model):
    """Every parameter's gradient of the phDOS training loss (targets not
    clamped), against jax.grad of the JAX loss: 1e-4 x max(1, max|grad|)
    per tensor; the loss rtol 1e-5."""
    jm, params = jax_model
    jb, tb = _train_batches(1)

    def loss_fn(p):
        dg, _, ds = jm.apply({"params": p}, jb[0], deterministic=True)
        return jloss.dos_loss(dg, ds, jb[0].y, jb[0].graph_mask, 1.0,
                              False)[0]

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = state_dict_from_jax(want, task="phdos")
    tm = _port_model(params)
    dg, _, ds = tm(tb[0])
    got_loss, _ = loss.dos_loss(dg, ds, tb[0].y, tb[0].graph_mask,
                                clamp_targets=False)
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    named = dict(tm.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        assert p.grad is not None, name
        _scaled_close(p.grad, want[name].numpy(), 1e-4, name)


def test_three_phdos_train_steps_match_jax_trainer(jax_model):
    """Per-step losses (rtol 1e-5) and the params after 3 steps (atol 1e-6,
    1% of one AdamW step at lr 1e-4) against the JAX Trainer with phDOS's
    settings (no target clamp, no eval clamp); then one unclamped eval on
    the real graphs (1e-4 x max(1, max|x|))."""
    jm, params = jax_model
    jb, tb = _train_batches()
    jt = JTrainer(jm, donate=False, clamp_targets=False, eval_clamp=False)
    state = TrainState.create(params, jt.tx, jax.random.PRNGKey(1))
    tm = _port_model(params)
    trainer = Trainer(tm, clamp_targets=False, eval_clamp=False)
    for j, t in zip(jb, tb):
        state, jout = jt.train_step(state, j)
        out = trainer.train_step(t)
        for k in ("loss", "rmse_global", "rmse_system"):
            np.testing.assert_allclose(out[k].item(), float(jout[k]),
                                       rtol=1e-5, err_msg=k)
    want = state_dict_from_jax(state.params, task="phdos")
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    m = trainer.eval_step(tb[0])
    jm_out = jt.eval_step(state.params, jb[0])
    for k in ("rmse", "mae", "preds", "embeddings", "preds_global"):
        _scaled_close(m[k][:3], np.asarray(jm_out[k])[:3], 1e-4, k)


def test_phdos_state_dicts(jax_model, tmp_path):
    """state_dict_from_jax(task="phdos") is the JAX package's reference
    export key for key (the phDOS spelling ``prompt_token``); the eDOS
    spelling does not load. A float64 state_dict in the reference's module
    structure (dead attention projections, node_mlp_1 and the free alpha
    included) loads strictly into the float32 model."""
    from test_import_torch import _FlagshipPhDOS  # the reference's names

    _, params = jax_model
    ours = state_dict_from_jax(params, task="phdos")
    ref = export_reference_state_dict(params, task="phdos")
    assert set(ours) == set(ref) and "prompt_token.weight" in ours
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    model = DOSTransformerPhDOS(layers=2, t_layers=1, hidden=H)
    assert set(model.state_dict()) == set(ours)
    model.load_state_dict(ours, strict=True)
    with pytest.raises(RuntimeError):
        model.load_state_dict(state_dict_from_jax(params), strict=True)
    with pytest.raises(ValueError):
        state_dict_from_jax(params, task="xdos")

    reference = _FlagshipPhDOS(h=H).double()
    torch.save(reference.state_dict(), tmp_path / "ref.pt")
    sd = torch.load(tmp_path / "ref.pt", weights_only=True)
    assert sd["fc.weight"].dtype == torch.float64
    port = build_model("phdos", "DOSTransformer_phonon", layers=2,
                       t_layers=2, hidden=H)
    load_reference_state_dict(port, sd, strict=True)
    for k, v in port.state_dict().items():
        assert v.dtype == torch.float32, k
        torch.testing.assert_close(v, sd[k].float(), rtol=0, atol=0)


def test_registry_builds_phdos_and_unported_options_raise():
    """Both names build; tp_axis (ported) builds the whole model; f64
    phDOS (ported) builds and returns f64 from the f32 weights; bins_pad
    (the do-not-port list) raises."""
    for name in ("DOSTransformer", "dostransformer_phonon"):
        m = build_model("phdos", name, layers=1, t_layers=1, hidden=H)
        assert isinstance(m, DOSTransformerPhDOS) and m.n_bins == 51
    m = build_model("phdos", hidden=H, layers=1, t_layers=1, tp_axis="model")
    assert m.tp_axis == "model"
    assert m.transformer.layers[0].fc1.weight.shape == (4 * H, H)
    m64 = build_model("phdos", hidden=H, layers=1, t_layers=1,
                      dtype="float64")
    _, tb = _batches()
    with torch.inference_mode():
        assert all(t.dtype == torch.float64 for t in m64(tb))
    with pytest.raises(NotImplementedError, match="do-not-port"):
        build_model("phdos", hidden=H, layers=1, t_layers=1, bins_pad=64)


# --- host data ----------------------------------------------------------


def test_synthetic_phdos_matches_jax():
    """Every array of every sample, exactly."""
    for make in ("synthetic_phdos_samples", "synthetic_phdos_learnable"):
        ours = getattr(synthetic, make)(5, seed=3)
        ref = getattr(jsyn, make)(5, seed=3)
        for a, b in zip(ours, ref):
            for f in dataclasses.fields(b):
                va, vb = getattr(a, f.name), getattr(b, f.name)
                if isinstance(vb, np.ndarray):
                    np.testing.assert_array_equal(va, vb, err_msg=f.name)
                else:
                    assert va == vb, f.name


def test_elements_and_config_match_jax():
    assert elements.SYMBOLS == jelements.SYMBOLS
    np.testing.assert_array_equal(elements.ATOMIC_MASSES,
                                  jelements.ATOMIC_MASSES)
    z = np.array([1, 6, 26, 118, 6])
    np.testing.assert_array_equal(elements.atomic_mass_features(z),
                                  jelements.atomic_mass_features(z))
    np.testing.assert_array_equal(elements.one_hot_types(z),
                                  jelements.one_hot_types(z))
    for name in ("Cubic", "Monoclinic", "Triclinic", "cubic", "", "nan"):
        for phonon in (True, False):
            assert (config.crystal_system_id(name, phonon=phonon)
                    == jcrystal_id(name, phonon=phonon))
    assert dataclasses.asdict(config.PhDOSDataConfig()) == {
        "n_bins": 51, "r_max": 4.0, "n_atom_feats": 118, "n_bond_feats": 4,
        "batch_size": 1}


def test_read_index_file_and_element_balanced_split_match_jax(tmp_path):
    path = tmp_path / "idx_train.txt"
    path.write_text("\n".join(map(str, [5, 0, 12, 3])))
    assert datasets.read_index_file(str(path)) == [5, 0, 12, 3]
    assert datasets.read_index_file(str(path)) == jdatasets.read_index_file(
        str(path))
    rng = np.random.RandomState(4)
    pool = ["Si", "O", "Fe", "Al", "Li", "Na", "Cl", "Mg"]
    species = [sorted(set(rng.choice(pool, size=rng.randint(1, 4))))
               for _ in range(60)]
    species[7] = ["Xe"]  # an element with one sample: too few to split
    for seed in (12, 0):
        got = datasets.element_balanced_split(species, seed=seed)
        assert got == jdatasets.element_balanced_split(species, seed=seed)
        assert sorted(sum(got, [])) == list(range(60))


@pytest.mark.parametrize("case", ["cubic", "triclinic_unwrapped", "slab"])
def test_neighbor_list_matches_jax(case):
    """(src, dst, shift) equal, in order, to the JAX package's search."""
    rng = np.random.RandomState(5)
    cell = np.eye(3) * 3.7
    pbc = (True, True, True)
    pos = rng.rand(5, 3) * 3.7
    if case == "triclinic_unwrapped":
        cell = np.array([[4.1, 0.0, 0.0], [1.3, 3.8, 0.0], [0.7, 0.9, 3.5]])
        pos = rng.rand(6, 3) @ cell + np.array([4.1, -3.8, 0.0])
    elif case == "slab":
        pbc = (True, True, False)
    for cutoff, self_interaction in ((4.0, True), (2.5, False)):
        got = neighbors.neighbor_list_pbc(pos, cell, cutoff, pbc,
                                          self_interaction)
        want = jneighbor_list_pbc(pos, cell, cutoff, pbc, self_interaction)
        assert len(got[0]) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _csv(path, n=12):
    from test_featurize_csv import _make_csv  # phononDoS-style rows

    _make_csv(str(path), n=n)


def test_featurize_csv_matches_jax(tmp_path):
    """Every array of every featurised crystal and the species lists equal
    the JAX featuriser's (pandas there, the csv module here); an empty
    crystal_system and mp_id read as pandas reads them."""
    import pandas as pd

    path = tmp_path / "data.csv"
    _csv(path)
    df = pd.read_csv(path)
    df.loc[2, "crystal_system"] = None
    df.loc[3, "mp_id"] = None
    df.to_csv(path, index=False)
    ours, sp = featurize_csv(str(path))
    ref, jsp = jfeaturize_csv(str(path))
    assert sp == jsp and len(ours) == len(ref) == 12
    assert ours[2].system == 6 and ours[3].mp_id == ref[3].mp_id
    for a, b in zip(ours, ref):
        for f in dataclasses.fields(b):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(vb, np.ndarray):
                np.testing.assert_array_equal(va, vb, err_msg=f.name)
            else:
                assert va == vb, f.name
    # the command line writes the same samples as an npz
    featurize_main([str(path), str(tmp_path / "out.npz")])
    loaded = load_samples(tmp_path / "out.npz")
    assert [s.mp_id for s in loaded] == [s.mp_id for s in ref]
    np.testing.assert_array_equal(loaded[5].edge_vec, ref[5].edge_vec)
    # no mp_id column: the row index
    df.drop(columns=["mp_id"]).to_csv(path, index=False)
    assert ([s.mp_id for s in featurize_csv(str(path))[0]]
            == [s.mp_id for s in jfeaturize_csv(str(path))[0]])


# --- entry points -------------------------------------------------------


def _small_run(tmp_path, *extra):
    return ["--epochs", "2", "--eval", "1", "--hidden", str(H), "--layers",
            "2", "--transformer", "1", "--batch_size", "4", "--device",
            "cpu", "--results_dir", str(tmp_path), *extra]


def test_main_phdos_trains_on_the_cpu(tmp_path):
    log = tmp_path / "run.jsonl"
    result = main_phdos.main(_small_run(
        tmp_path, "--synthetic", "20", "--synthetic_learnable",
        "--debug_nans", "--log_jsonl", str(log)))
    assert set(result["test"]) == {"rmse", "mse", "mae", "r2"}
    assert all(np.isfinite(v) for v in result["test"].values())
    assert result["best_epoch"] in (1, 2) and result["samples_per_sec"] > 0
    assert len(log.read_text().splitlines()) >= 4
    # the experiments block is byte-identical to the JAX package's
    cfg = config.TrainConfig(epochs=2, eval_every=1, hidden=H, layers=2,
                             transformer=1, batch_size=4)
    jcfg = JConfig(epochs=2, eval_every=1, hidden=H, layers=2, transformer=1,
                   batch_size=4)
    assert config.exp_get_name(cfg) == jexp_get_name(jcfg)
    _write_results_line("phdos", jcfg, result, str(tmp_path / "jax"))
    name = "experiments_DOSTransformer.txt"
    assert ((tmp_path / name).read_bytes()
            == (tmp_path / "jax" / name).read_bytes())


def test_main_phdos_trains_from_a_csv(tmp_path):
    """data.csv featurised, the element-balanced split written as the JAX
    package's splitter writes it, then read back on a second run."""
    d = tmp_path / "processed"
    d.mkdir()
    _csv(d / "data.csv", n=24)
    result = main_phdos.main(_small_run(tmp_path, "--data_dir", str(d)))
    assert np.isfinite(result["test"]["rmse"])
    _, species = jfeaturize_csv(str(d / "data.csv"))
    want = jdatasets.element_balanced_split(species, 0.1, 0.1, seed=12)
    got = [datasets.read_index_file(str(d / f"idx_{s}.txt"))
           for s in ("train", "valid", "test")]
    assert got == [list(w) for w in want]
    (d / "idx_valid.txt").write_text("20\n21")
    (d / "idx_test.txt").write_text("22\n23")
    (d / "idx_train.txt").write_text("\n".join(map(str, range(20))))
    result = main_phdos.main(_small_run(tmp_path, "--data_dir", str(d)))
    assert np.isfinite(result["test"]["rmse"])
    with pytest.raises(SystemExit):
        main_phdos.main(_small_run(tmp_path, "--data_dir",
                                   str(tmp_path / "missing")))


def test_main_phdos_rejects_x64_with_its_roadmap_entry(tmp_path):
    """--x64 is ported: main_phdos --x64 trains (finite losses and test
    metrics; tests/test_torch_f64.py holds it against the JAX CLI)."""
    result = main_phdos.main(_small_run(tmp_path, "--synthetic", "12",
                                        "--x64"))
    assert all(np.isfinite(v) for v in result["test"].values())


_BLOCKED_RUN = """
import importlib.abc, importlib.machinery, sys
class Blocked(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    # found, as an installed package is, but importing it fails
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "pandas",
                                  "dostransformer_tpu"):
            return importlib.machinery.ModuleSpec(name, self)
    def create_module(self, spec):
        return None
    def exec_module(self, module):
        raise ImportError(module.__name__ + " is not installed here")
sys.meta_path.insert(0, Blocked())
from dostransformer_tpu_torch.cli import main_phdos
main_phdos.main(sys.argv[1:])
"""


def test_main_phdos_runs_without_jax_or_pandas(tmp_path):
    """The card's machine has neither: main_phdos trains from synthetic
    data and from a data.csv with jax, flax, pandas and the JAX package
    unimportable."""
    d = tmp_path / "processed"
    d.mkdir()
    _csv(d / "data.csv", n=12)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    for data in (["--synthetic", "12"], ["--data_dir", str(d)]):
        out = subprocess.run(
            [sys.executable, "-c", _BLOCKED_RUN,
             *_small_run(tmp_path, "--epochs", "1", *data)],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        assert "best epoch" in out.stdout


def _mixed_request():
    """Small (bucket 8) and large (bucket 16) crystals interleaved."""
    small = jsyn.synthetic_phdos_samples(4, seed=20, min_atoms=2,
                                         max_atoms=6)
    large = jsyn.synthetic_phdos_samples(2, seed=21, min_atoms=10,
                                         max_atoms=14)
    return [small[0], large[0], small[1], small[2], large[1], small[3]]


def test_phdos_predictor_and_cli_match_jax_unclamped(tmp_path):
    """Predictor.from_torch(task="phdos") and main_predict --task phdos
    against the JAX Predictor with no clamp, atol 1e-4: negative outputs
    stay negative."""
    request = _mixed_request()
    jm = JModel(layers=2, t_layers=1, hidden=H)
    params = jm.init(jax.random.PRNGKey(7), jcollate(request[:2]))
    path = tmp_path / "phdos.pt"
    torch.save(state_dict_from_jax(params, task="phdos"), path)
    want = JPredictor(jm, params["params"], batch_size=3,
                      clamp=False).predict(request)
    assert (want < 0).any()
    port = _port(request)
    pred = Predictor.from_torch(path, task="phdos", example=port[0],
                                layers=2, t_layers=1, hidden=H, batch_size=3,
                                device="cpu")
    assert not pred.clamp
    got = pred.predict(port)
    assert got.shape == (6, 51)
    np.testing.assert_allclose(got, want, **MODEL_TOL)
    save_samples(tmp_path / "in.npz", port)
    dos = main_predict.main([
        "--task", "phdos", "--torch_state_dict", str(path),
        "--input", str(tmp_path / "in.npz"), "--output",
        str(tmp_path / "out.npz"), "--layers", "2", "--transformer", "1",
        "--hidden", str(H), "--batch_size", "4", "--device", "cpu"])
    np.testing.assert_allclose(dos, want, **MODEL_TOL)
