"""The PyTorch port's modules and the whole eDOS model against the JAX
package on the CPU, on identical weights (state_dict_from_jax) and inputs
(numpy from a seed), small size: hidden 32, 2 processors, 1 transformer layer
per stack, a batch of 3 samples plus one dummy graph.

Tolerances, f32 on both sides: atol 1e-5 for one module, atol 1e-4 (rtol
1e-4) for the whole model, whose outputs pass through ~10 layers of matrix
products summed in a different order."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from dostransformer_tpu.data import collate as jcollate  # noqa: E402
from dostransformer_tpu.data import synthetic_edos_samples  # noqa: E402
from dostransformer_tpu.models import DOSTransformerEDOS as JModel  # noqa: E402
from dostransformer_tpu.models.import_torch import (  # noqa: E402
    export_reference_state_dict,
)
from dostransformer_tpu.nn import modules as jmodules  # noqa: E402
from dostransformer_tpu.nn import transformer as jtransformer  # noqa: E402
from dostransformer_tpu_torch.data.graph import GraphSample, collate  # noqa: E402
from dostransformer_tpu_torch.models.dostransformer import (  # noqa: E402
    DOSTransformerEDOS,
)
from dostransformer_tpu_torch.models.import_torch import (  # noqa: E402
    state_dict_from_jax,
)
from dostransformer_tpu_torch.models.registry import build_model  # noqa: E402
from dostransformer_tpu_torch.nn.modules import Processor, TorchLinear  # noqa: E402
from dostransformer_tpu_torch.nn.transformer import TransformerEncoder  # noqa: E402

H = 32
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _batches(seed=5):
    samples = synthetic_edos_samples(3, seed=seed)
    port = [GraphSample(**vars(s)) for s in samples]
    return jcollate(samples, num_graphs=4), collate(port, num_graphs=4)


def _load(module, jax_params):
    module.load_state_dict(state_dict_from_jax(jax_params), strict=True)
    return module


def test_torch_linear_split_gather_form_matches_jax():
    """Project each part through its slice of the weight, then gather:
    the same as gathering, concatenating and projecting."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 5, 8).astype(np.float32)
    e = rng.randn(2, 7, 3).astype(np.float32)
    snd, rcv = (rng.randint(0, 5, (2, 7)).astype(np.int32) for _ in range(2))
    jl = jmodules.TorchLinear(6)
    jparts = ((jnp.asarray(x), jnp.asarray(snd)),
              (jnp.asarray(x), jnp.asarray(rcv)), (jnp.asarray(e), None))
    params = jl.init(jax.random.PRNGKey(5), jparts)
    want = jl.apply(params, jparts)
    tl = _load(TorchLinear(19, 6), params)
    tx, te = torch.from_numpy(x), torch.from_numpy(e)
    ts, tr = torch.from_numpy(snd), torch.from_numpy(rcv)
    got = tl(((tx, ts), (tx, tr), (te, None)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODULE_TOL)
    rows = lambda t, i: t[torch.arange(2)[:, None], i.long()]
    concat = tl(torch.cat([rows(tx, ts), rows(tx, tr), te], -1))
    torch.testing.assert_close(got, concat, **MODULE_TOL)


@pytest.mark.parametrize("masked", [True, False])
def test_transformer_encoder_matches_jax(masked):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 11, H).astype(np.float32)
    kv = rng.randn(3, 6, H).astype(np.float32)
    km = rng.rand(3, 6) > 0.3
    # a dummy graph, as the model makes it: no real atom, zero key rows
    km[-1] = False
    kv[-1] = 0.0
    km = km if masked else None
    jm = jtransformer.TransformerEncoder(embed_dim=H, layers=2,
                                         use_pallas=True)
    args = (jnp.asarray(x), jnp.asarray(kv), jnp.asarray(kv),
            None if km is None else jnp.asarray(km))
    params = jm.init(jax.random.PRNGKey(1), *args)
    want = jm.apply(params, *args)
    tm = _load(TransformerEncoder(H, layers=2), params)
    got = tm(torch.from_numpy(x), torch.from_numpy(kv), torch.from_numpy(kv),
             None if km is None else torch.from_numpy(km))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODULE_TOL)
    # k/v omitted == self-attention; one-sided k/v is an error
    want_self = jm.apply(params, jnp.asarray(x))
    got_self = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got_self.detach().numpy(),
                               np.asarray(want_self), **MODULE_TOL)
    with pytest.raises(ValueError):
        tm(torch.from_numpy(x), torch.from_numpy(kv), None)


@pytest.mark.parametrize("fused", [False, True])
def test_processor_matches_jax(fused):
    jb, tb = _batches()
    rng = np.random.RandomState(2)
    x = rng.randn(4, jb.atoms_per_graph, H).astype(np.float32)
    e = rng.randn(4, jb.edges_per_graph, H).astype(np.float32)
    jm = jmodules.Processor(H, use_fused_mp=fused)
    args = (jnp.asarray(x), jb.senders, jb.receivers, jnp.asarray(e),
            jb.edge_mask)
    params = jm.init(jax.random.PRNGKey(3), *args)
    want = jm.apply(params, *args)
    tm = _load(Processor(H), params)
    got = tm(torch.from_numpy(x), tb.senders, tb.receivers,
             torch.from_numpy(e), tb.edge_mask)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   **MODULE_TOL)


@pytest.mark.parametrize("padding", ["mask", "ref"])
@pytest.mark.parametrize("kernels", [False, True],
                         ids=["jax_plain", "jax_pallas"])
def test_edos_forward_matches_jax(padding, kernels):
    """All three outputs, against JAX run through its Pallas kernels
    (interpret mode) and through its plain jnp paths."""
    jb, tb = _batches()
    jm = JModel(layers=2, t_layers=1, hidden=H, padding=padding,
                use_pallas=kernels, use_fused_mp=kernels)
    params = jm.init(jax.random.PRNGKey(0), jb)
    want = jm.apply(params, jb)
    tm = _load(DOSTransformerEDOS(layers=2, t_layers=1, hidden=H,
                                  padding=padding), params)
    with torch.inference_mode():
        got = tm(tb)
    assert [tuple(g.shape) for g in got] == [(4, 201), (4, 32, H), (4, 201)]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL)


def test_state_dict_from_jax_equals_reference_export():
    jb, _ = _batches()
    params = JModel(layers=2, t_layers=1, hidden=H).init(
        jax.random.PRNGKey(4), jb)
    ours = state_dict_from_jax(params)
    ref = export_reference_state_dict(params, task="edos")
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    model = DOSTransformerEDOS(layers=2, t_layers=1, hidden=H)
    assert set(model.state_dict()) == set(ours)
    assert not model.load_state_dict(ours, strict=True).missing_keys


def test_init_is_seeded():
    """Same generator seed -> same weights; torch-default bounds."""
    make = lambda s: DOSTransformerEDOS(layers=1, t_layers=1, hidden=H,
                                        generator=torch.Generator()
                                        .manual_seed(s)).state_dict()
    a, b, c = make(0), make(0), make(1)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    w = a["fc.weight"]
    assert w.abs().max() <= (2 * H) ** -0.5
    assert torch.equal(a["transformer.layers.0.fc1.bias"],
                       torch.zeros(4 * H))
    assert torch.equal(a["stacked_processor.0.edge_model.edge_mlp.2.weight"],
                       torch.full((1,), 0.25))


@pytest.mark.parametrize("kwargs", [{"attn_drop": 0.1}, {"dtype": "bfloat16"},
                                    {"bins_pad": 256}, {"tp_axis": "model"}])
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model("edos", hidden=H, layers=1, t_layers=1, **kwargs)


@pytest.mark.parametrize("task,embedder", [
    ("edos", "DOSTransformer"), ("edos", "graphnetwork"),
    ("edos", "Graphnetwork2"), ("edos", "mlp"), ("edos", "MLP2"),
    ("phdos", "DOSTransformer"), ("phdos", "DOSTransformer_phonon"),
    ("phdos", "graphnetwork"), ("phdos", "graphnetwork2"), ("phdos", "mlp"),
    ("phdos", "mlp2")])
def test_registry_builds_every_family(task, embedder):
    """Each of the JAX registry's 11 (task, embedder) names builds
    (case-insensitively); an unknown name or task still raises."""
    model = build_model(task, embedder, hidden=H, layers=1, t_layers=1)
    assert sum(p.numel() for p in model.parameters()) > 0
    with pytest.raises(ValueError):
        build_model(task, "no_such_model")
    with pytest.raises(ValueError):
        build_model("no_such_task", embedder)
