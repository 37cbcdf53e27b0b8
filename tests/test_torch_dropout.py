"""The port's dropout (attention weights, the transformer layer's dropouts,
the Trainer's dropout stream) against the JAX package on the CPU: the
cases of tests/test_dropout.py with a torch.Generator in place of the key,
exact parity with the JAX attention given the JAX package's own mask, remat
and resume under dropout, and the stream on 'data' and 'model' ranks.

Small sizes: hidden 32, 1-2 layers, batches of 4. Tolerances, each stated
where it is used: the attention against JAX on one mask rtol = atol = 1e-5
(the attention tolerance of tests/test_torch_ops.py), forward and
gradients; the statistics within 4 standard errors (5 for each element of
the unbiasedness check, as in tests/test_dropout.py); everything drawn from
one generator state bit-equal."""

import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from dostransformer_tpu.ops.attention import (  # noqa: E402
    dot_product_attention as jattention,
)
from dostransformer_tpu_torch.cli import main_edos, main_phdos  # noqa: E402
from dostransformer_tpu_torch.data import graph  # noqa: E402
from dostransformer_tpu_torch.data.datasets import GraphLoader  # noqa: E402
from dostransformer_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_edos_learnable,
    synthetic_phdos_learnable,
)
from dostransformer_tpu_torch.models.registry import build_model  # noqa: E402
from dostransformer_tpu_torch.nn import dropout as tdropout  # noqa: E402
from dostransformer_tpu_torch.nn import transformer  # noqa: E402
from dostransformer_tpu_torch.ops.attention import (  # noqa: E402
    dot_product_attention,
    fused_attention,
    masked_attention,
)
from dostransformer_tpu_torch.train.optim import make_adamw  # noqa: E402
from dostransformer_tpu_torch.train.trainer import Trainer  # noqa: E402
from test_torch_parallel_init import run_worker  # noqa: E402

H = 32
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(b=4, lq=8, lk=64, d=64, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(b, n, d).astype(np.float32))
                 for n in (lq, lk, lk))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# --- the attention weights -------------------------------------------------


class TestAttentionWeightDropout:
    """Observed through a v = I probe: with v = eye(Lk) (Lk == D) the
    attention output rows ARE the weight rows after dropout."""

    RATE, DRAWS = 0.3, 200

    def _weights(self, rate, generator, b=2, lq=8, lk=64):
        q, k, _ = _qkv(b=b, lq=lq, lk=lk, d=lk)
        v = torch.eye(lk).expand(b, lk, lk)
        return dot_product_attention(q, k, v, None, dropout_rate=rate,
                                     generator=generator)

    def test_drop_rate_scaling_and_unbiasedness(self):
        w0 = self._weights(0.0, None).numpy()
        assert (w0 > 0).all()
        np.testing.assert_allclose(w0.sum(-1), 1.0, atol=1e-5)
        g = _gen(42)
        dropped = np.stack([self._weights(self.RATE, g).numpy()
                            for _ in range(self.DRAWS)])
        p, n = self.RATE, dropped.size
        # the Bernoulli rate: dropped slots are exactly the zeros
        zero_frac = (dropped == 0.0).mean()
        assert abs(zero_frac - p) <= 4 * np.sqrt(p * (1 - p) / n), zero_frac
        # kept slots are w0 / (1 - p)
        kept = dropped != 0.0
        np.testing.assert_allclose(
            dropped[kept],
            np.broadcast_to(w0 / np.float32(1 - p), dropped.shape)[kept],
            rtol=1e-6)
        # unbiased: the mean over draws is w0; relative error per element
        # has standard error sqrt(p / (1 - p) / DRAWS)
        se = np.sqrt(p / (1 - p) / self.DRAWS)
        rel = (dropped.mean(0) - w0) / w0
        assert (np.abs(rel) <= 5 * se).all()
        assert abs(rel.mean()) <= 4 * se / np.sqrt(rel.size)

    def test_masked_keys_stay_masked_under_dropout(self):
        b, lk = 2, 64
        q, k, _ = _qkv(b=b, lk=lk, d=lk, seed=1)
        v = torch.eye(lk).expand(b, lk, lk)
        mask = torch.arange(lk)[None] < torch.tensor([[40], [50]])
        w = dot_product_attention(q, k, v, mask, dropout_rate=0.3,
                                  generator=_gen(7))
        assert (w[0, :, 40:] == 0).all() and (w[1, :, 50:] == 0).all()

    def test_eval_contract_is_exactly_the_deterministic_forward(self):
        """A rate without a generator, and rate 0 with one, are the forward
        without dropout bit for bit; so is the op (the plain version on the
        CPU), which takes no dropout."""
        q, k, v = _qkv()
        base = dot_product_attention(q, k, v, None)
        assert torch.equal(base, dot_product_attention(q, k, v, None,
                                                       dropout_rate=0.5))
        assert torch.equal(base, dot_product_attention(
            q, k, v, None, dropout_rate=0.0, generator=_gen(0)))
        assert torch.equal(base, fused_attention(q, k, v, None))

    def test_the_layer_hands_dropout_to_the_plain_version(self, monkeypatch):
        """The transformer layer with an attention mask drawn runs the
        plain masked attention and not the op; without one, the op. With
        the mask it equals masked_attention on the layer's normed inputs,
        bit for bit, and drops."""
        calls = []
        for name in ("fused_attention", "masked_attention"):
            original = getattr(transformer, name)
            monkeypatch.setattr(transformer, name,
                                lambda *a, _f=original, _n=name:
                                calls.append(_n) or _f(*a))
        x, kv, _ = _qkv(b=4, lq=8, lk=16, d=H)
        mask = torch.ones(4, 16, dtype=torch.bool)
        mask[:, 12:] = False
        layer = transformer.TransformerEncoderLayer(H, attn_dropout=0.25)
        masks = layer.draw_masks(x, kv, _gen(3))
        assert masks.attn.shape == (4, 8, 16) and masks.res0 is None
        got = layer(x, kv, kv, mask, masks)
        assert calls == ["masked_attention"]
        ln0 = layer.layer_norms[0]
        k = ln0(kv)
        a = masked_attention(ln0(x), k, k, mask, masks.attn, 0.25)
        want = x + a
        want = want + layer.fc2(torch.relu(layer.fc1(
            layer.layer_norms[1](want))))
        assert torch.equal(got, want)
        calls.clear()
        assert not torch.equal(got, layer(x, kv, kv, mask))
        assert calls == ["fused_attention"]

    def test_gradients_flow_and_respect_the_mask(self):
        """d(loss)/dv is 0 exactly at the keys whose weight column was
        dropped for every query."""
        q, k, v = _qkv(b=1, lq=4, lk=8, d=8, seed=2)
        eye = torch.eye(8)[None]
        for seed in range(64):
            w = dot_product_attention(q, k, eye, None, dropout_rate=0.4,
                                      generator=_gen(seed))[0]
            dead = (w == 0).all(0)
            if dead.any() and not dead.all():
                break
        else:
            pytest.fail("no seed in 64 dropped a whole key")
        v = v.requires_grad_()
        out = dot_product_attention(q, k, v, None, dropout_rate=0.4,
                                    generator=_gen(seed))
        (out ** 2).sum().backward()
        assert torch.isfinite(v.grad).all()
        assert (v.grad[0][dead] == 0).all() and (v.grad[0][~dead] != 0).any()

    @pytest.mark.parametrize("masked", [False, True])
    def test_exact_parity_with_jax_given_its_mask(self, masked):
        """JAX's dot_product_attention(dropout_rate=0.25, dropout_rng=key)
        against masked_attention fed jax.random.bernoulli(key, 0.75,
        [B, Lq, Lk]): the outputs and the gradients of sum(out * g) in q, k
        and v within 1e-5."""
        b, lq, lk, d = 3, 9, 13, 16
        rng = np.random.RandomState(5)
        q, k, v, g = (rng.randn(b, n, d).astype(np.float32)
                      for n in (lq, lk, lk, lq))
        km = rng.rand(b, lk) > 0.3 if masked else None
        key = jax.random.PRNGKey(11)
        keep = np.asarray(jax.random.bernoulli(key, 0.75, (b, lq, lk)))
        assert 0 < keep.mean() < 1

        def jloss(q_, k_, v_):
            out = jattention(q_, k_, v_, None if km is None
                             else jnp.asarray(km), dropout_rate=0.25,
                             dropout_rng=key)
            return (out * g).sum(), out

        (_, want), jgrads = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
        tq, tk, tv = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
        got = masked_attention(tq, tk, tv, None if km is None
                               else torch.from_numpy(km),
                               torch.from_numpy(keep), 0.25)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **ATTN_TOL)
        (got * torch.from_numpy(g)).sum().backward()
        for t, jg in zip((tq, tk, tv), jgrads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                       **ATTN_TOL)

    def test_dropout_helpers(self):
        """rate 0 or no generator: the tensor itself; rate 1: zeros; a bf16
        operand is divided by bf16(1 - rate), as JAX divides it."""
        x = torch.randn(4, 5)
        assert tdropout.dropout(x, 0.0, _gen(0)) is x
        assert tdropout.dropout(x, 0.5, None) is x
        assert torch.equal(tdropout.dropout(x, 1.0, _gen(0)),
                           torch.zeros_like(x))
        keep = torch.ones(4, 5, dtype=torch.bool)
        xb = x.bfloat16()
        assert tdropout.keep_scale(0.1, torch.bfloat16) == 0.8984375
        want = jnp.asarray(xb.float().numpy(), jnp.bfloat16) / 0.9
        np.testing.assert_array_equal(
            tdropout.apply_keep(xb, keep, 0.1).float().numpy(),
            np.asarray(want.astype(jnp.float32)))


# --- the model and the Trainer ----------------------------------------------


def _edos_batch(n=4, seed=0):
    return next(iter(GraphLoader(synthetic_edos_learnable(n, seed=seed), n)))


def _model(attn_drop=0.0, **kw):
    return build_model("edos", layers=2, t_layers=1, hidden=H,
                       attn_drop=attn_drop, generator=_gen(0), **kw)


class TestModelDropout:
    def test_train_mode_stochastic_eval_mode_deterministic(self):
        batch = _edos_batch()
        model, model0 = _model(0.5), _model(0.0)
        for a, b in zip(model.state_dict().values(),
                        model0.state_dict().values()):
            assert torch.equal(a, b)  # attn_drop adds no parameter
        model.eval()
        base = model0.eval()(batch)
        # eval: deterministic, with or without a generator
        for out in (model(batch), model(batch, generator=_gen(1))):
            for a, b in zip(out, base):
                assert torch.equal(a, b)
        model.train()
        # training mode without a generator: no dropout
        for a, b in zip(model(batch), base):
            assert torch.equal(a, b)
        tr1 = model(batch, generator=_gen(1))
        tr1b = model(batch, generator=_gen(1))
        tr2 = model(batch, generator=_gen(2))
        assert torch.equal(tr1[0], tr1b[0])
        assert not torch.equal(tr1[0], tr2[0])
        assert not torch.equal(tr1[0], base[0])
        assert torch.isfinite(tr1[0]).all()

    def test_a_rate_zero_model_ignores_the_generator(self):
        model = _model(0.0).train()
        batch = _edos_batch()
        for a, b in zip(model(batch), model(batch, generator=_gen(4))):
            assert torch.equal(a, b)

    def test_trainer_threads_the_stream(self):
        """Two Trainers of one seed give the same losses; with the
        parameters held fixed (lr 0, no decay) two steps draw different
        masks (different losses); without dropout they do not."""
        batch = _edos_batch()

        def losses(attn_drop, seed, lr=1e-4, wd=1e-2):
            model = _model(attn_drop)
            trainer = Trainer(model, make_adamw(model.parameters(), lr, wd),
                              seed=seed)
            return [trainer.train_step(batch)["loss"].item()
                    for _ in range(2)]

        assert losses(0.3, 0) == losses(0.3, 0)
        assert losses(0.3, 0) != losses(0.3, 1)
        fixed = losses(0.3, 0, lr=0.0, wd=0.0)
        assert fixed[0] != fixed[1]
        fixed0 = losses(0.0, 0, lr=0.0, wd=0.0)
        assert fixed0[0] == fixed0[1]
        # eval stays deterministic after training with dropout
        model = _model(0.3)
        trainer = Trainer(model, seed=0)
        trainer.train_step(batch)
        a, b = trainer.eval_step(batch), trainer.eval_step(batch)
        assert torch.equal(a["preds"], b["preds"])

    @pytest.mark.parametrize("task", ["edos", "phdos"])
    def test_remat_gives_the_same_gradients_under_dropout(self, task):
        """remat recomputes each layer in the backward; the masks are drawn
        before the layer runs and handed in, so the gradients from one
        generator state equal those without remat, bit for bit on the
        CPU."""
        make = (synthetic_edos_learnable if task == "edos"
                else synthetic_phdos_learnable)
        batch = graph.collate(make(3, seed=1), num_graphs=4)
        grads = []
        for remat in (False, True):
            model = build_model(task, layers=2, t_layers=2, hidden=H,
                                generator=_gen(0), remat=remat,
                                attn_drop=0.3).train()
            dg, _, ds = model(batch, generator=_gen(9))
            (dg.square().sum() + ds.sum()).backward()
            grads.append({n: p.grad for n, p in model.named_parameters()})
        for name, g in grads[0].items():
            assert torch.equal(g, grads[1][name]), name


# --- the entry points -------------------------------------------------------


def _phdos_flags(tmp_path, name, epochs, *extra):
    return ["--synthetic", "24", "--synthetic_learnable", "--epochs",
            str(epochs), "--eval", "2", "--hidden", "16", "--layers", "1",
            "--transformer", "1", "--batch_size", "4", "--device", "cpu",
            "--attn_drop", "0.1", "--results_dir", str(tmp_path / name),
            "--log_jsonl", str(tmp_path / name / "log.jsonl"), *extra]


def _epoch_losses(path):
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return {r["epoch"]: r["loss"] for r in rows if "loss" in r}


def test_main_edos_with_attn_drop_learns(tmp_path):
    """main_edos --attn_drop 0.1: every epoch loss finite, the last below
    the first; the test metrics finite."""
    log = tmp_path / "log.jsonl"
    result = main_edos.main([
        "--synthetic", "32", "--synthetic_learnable", "--epochs", "6",
        "--eval", "3", "--hidden", str(H), "--layers", "2", "--transformer",
        "1", "--batch_size", "4", "--attn_drop", "0.1", "--device", "cpu",
        "--lr", "1e-3", "--results_dir", str(tmp_path),
        "--log_jsonl", str(log)])
    assert np.isfinite(result["test"]["rmse"])
    losses = list(_epoch_losses(log).values())
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_resume_under_dropout_is_bit_equal(tmp_path):
    """A --attn_drop 0.1 run stopped after epoch 2 and resumed to epoch 4
    gives the uninterrupted run's epoch losses and best metrics exactly:
    the checkpoint carries the dropout stream's state. The same run
    without --attn_drop gives other losses (the dropout acted)."""
    ck = ["--checkpoint_every", "2", "--checkpoint_dir"]
    full = main_phdos.main(_phdos_flags(tmp_path, "a", 4, *ck,
                                        str(tmp_path / "cka")))
    main_phdos.main(_phdos_flags(tmp_path, "b", 2, *ck,
                                 str(tmp_path / "ckb")))
    resumed = main_phdos.main(_phdos_flags(tmp_path, "b", 4, *ck,
                                           str(tmp_path / "ckb")))
    assert _epoch_losses(tmp_path / "a" / "log.jsonl") == _epoch_losses(
        tmp_path / "b" / "log.jsonl")
    for k in ("best_epoch", "best_valid_rmse", "best_valid_mae", "test"):
        assert resumed[k] == full[k], k
    main_phdos.main(_phdos_flags(tmp_path, "c", 2, "--attn_drop", "0"))
    plain = _epoch_losses(tmp_path / "c" / "log.jsonl")
    with_dropout = _epoch_losses(tmp_path / "a" / "log.jsonl")
    assert all(plain[e] != with_dropout[e] for e in plain)


# --- the stream on 'data' and 'model' ranks ----------------------------------

RANKS_WORKER = """
import dostransformer_tpu_torch.nn.transformer as tr
from dostransformer_tpu_torch.data.graph import GraphBatch
from dostransformer_tpu_torch.models.registry import build_model
from dostransformer_tpu_torch.parallel.mesh import gather_host
from dostransformer_tpu_torch.train.trainer import Trainer
case = torch.load(sys.argv[1], weights_only=True)
dp, tp = case["shape"]
m = pmesh.make_mesh((dp, tp), ("data", "model"))
drawn = []
original = tr.draw_keep
def recording(shape, rate, generator, device):
    keep = original(shape, rate, generator, device)
    drawn.append(keep.clone())
    return keep
tr.draw_keep = recording
out = {}
for rate in (0.0, 0.3):
    model = build_model("edos", hidden=%d, layers=1, t_layers=1,
                        attn_drop=rate, tp_axis="model" if tp > 1 else None)
    model.load_state_dict(case["params"], strict=True)
    trainer = Trainer(model, mesh=m, seed=0)
    drawn.clear()
    losses = [trainer.train_step(GraphBatch(**b))["loss"].item()
              for b in case["batches"]]
    emb = model.embeddings.weight.detach().clone()
    out[rate] = {"losses": losses, "masks": [d.clone() for d in drawn],
                 "embeddings": emb}
torch.save(out, sys.argv[2] + f".{RANK}")
print("DROPOUT_OK", RANK, flush=True)
""" % H


@pytest.fixture(scope="module")
def rank_case():
    batches = [graph.collate(synthetic_edos_learnable(8, seed=s))
               for s in (1, 2)]
    model = build_model("edos", hidden=H, layers=1, t_layers=1,
                        generator=_gen(0))
    params = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(model, seed=0)
    losses = [trainer.train_step(b)["loss"].item() for b in batches]
    return {"params": params, "losses": losses,
            "batches": [{f.name: getattr(b, f.name)
                         for f in dataclasses.fields(b)} for b in batches]}


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["dp2", "tp2"])
def test_dropout_stream_on_data_and_model_ranks(shape, rank_case, tmp_path):
    """Two gloo ranks, 2 steps. 'data' ranks (DP x 2) draw different masks;
    'model' ranks (TP x 2) draw the same masks, and their replicated
    parameters stay bit-equal. At dropout 0 both meshes give the losses of
    one process (rtol 1e-5)."""
    case = dict(rank_case, shape=shape)
    torch.save(case, tmp_path / "case.pt")
    run_worker(tmp_path, RANKS_WORKER, 2,
               args=(tmp_path / "case.pt", tmp_path / "out.pt"))
    runs = [torch.load(f"{tmp_path / 'out.pt'}.{r}", weights_only=True)
            for r in range(2)]
    for run in runs:
        np.testing.assert_allclose(run[0.0]["losses"], rank_case["losses"],
                                   rtol=1e-5)
        assert run[0.0]["masks"] == []
        # 3 stacks x 1 layer, 2 steps: one attention mask a layer a step
        assert len(run[0.3]["masks"]) == 6
    a, b = (run[0.3]["masks"] for run in runs)
    same = [torch.equal(x, y) for x, y in zip(a, b)]
    if shape == (2, 1):
        assert not any(same)
    else:
        assert all(same)
        assert torch.equal(runs[0][0.3]["embeddings"],
                           runs[1][0.3]["embeddings"])


def test_a_dropout_model_serves_deterministically(tmp_path):
    """A model built with attn_drop, trained a step with dropout, serves
    through Predictor (eval mode, no generator) twice bit for bit, equal to
    the same weights in a model without dropout; its export traces the
    eval forward (one attention op a call, as without dropout) and serves
    the live Predictor's bits."""
    from test_torch_export import _dostpu_ops

    from dostransformer_tpu_torch.serve import ExportedPredictor, Predictor

    samples = synthetic_edos_learnable(6, seed=3)
    model = _model(0.3)
    Trainer(model, seed=0).train_step(_edos_batch())
    plain = _model(0.0)
    plain.load_state_dict(model.state_dict())
    pred = Predictor(model, batch_size=4, clamp=True)
    first = pred.predict(samples)
    assert np.array_equal(first, pred.predict(samples))
    assert np.array_equal(first, Predictor(plain, batch_size=4,
                                           clamp=True).predict(samples))
    pred.export(str(tmp_path / "art"), samples)
    assert _dostpu_ops(str(tmp_path / "art")) == {
        "fused_mp_edge_fwd": 2, "attention_fwd": 3}
    got = ExportedPredictor(str(tmp_path / "art"),
                            device="cpu").predict(samples)
    assert np.array_equal(got, pred.predict(samples, bucketed=False))
