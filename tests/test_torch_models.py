"""Port's transformer against the JAX package's, on the same weights.

The JAX parameters are made by ``ray_tpu.models.transformer.init_params``
and carried across with ``params_from_numpy``; tokens come from seeded
numpy. On the CPU the port's attention runs its plain versions (forward,
and backward through ``_FlashAttention``) and the JAX flash path runs the
Pallas kernels in interpret mode. Logits compare at 2e-4, as do the loss
and its gradients. The ``mesh=`` cases run the port's per-rank bodies on 4
spawned gloo ranks (once for the module) against the JAX model without a
mesh.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jax_transformer
from ray_tpu_torch import entry as port_entry
from ray_tpu_torch.models import transformer
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.parallel import run_spmd

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
            max_seq_len=128)


def _configs(**overrides):
    kw = {**TINY, **overrides}
    return (jax_transformer.TransformerConfig(**kw, dtype=jnp.float32),
            TransformerConfig(**kw, dtype=torch.float32))


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


def _jax_params_numpy(cfg):
    params = jax_transformer.init_params(jax.random.PRNGKey(0), cfg)
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("use_flash,n_kv_heads", [(False, None), (True, None),
                                                  (True, 2)],
                         ids=["dense", "flash", "flash-gqa"])
def test_logits_match_jax(use_flash, n_kv_heads):
    jcfg, cfg = _configs(use_flash=use_flash, n_kv_heads=n_kv_heads)
    np_params = _jax_params_numpy(jcfg)
    tokens = _tokens(1, (2, 48))
    want = jax_transformer.apply(jax.tree.map(jnp.asarray, np_params),
                                 jnp.asarray(tokens), jcfg)
    params = transformer.params_from_numpy(np_params, cfg, "cpu")
    got = transformer.apply(params, torch.tensor(tokens), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def _flat(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, in sorted key order."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _flat(tree[key], f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", tree[key]


def _port_loss_and_grads(params, tokens, cfg):
    leaves = [t.requires_grad_() for _, t in _flat(params)]
    loss = transformer.loss_fn(params, tokens, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss, dict(zip((path for path, _ in _flat(params)), grads))


@pytest.mark.parametrize("use_flash,n_kv_heads", [(False, None), (True, None),
                                                  (True, 2)],
                         ids=["dense", "flash", "flash-gqa"])
def test_loss_and_grads_match_jax(use_flash, n_kv_heads):
    """``loss_fn`` and its gradient against ``jax.value_and_grad`` of the
    JAX ``loss_fn`` (remat on in both), f32."""
    jcfg, cfg = _configs(use_flash=use_flash, n_kv_heads=n_kv_heads)
    np_params = _jax_params_numpy(jcfg)
    tokens = _tokens(5, (2, 33))
    want_loss, want = jax.value_and_grad(jax_transformer.loss_fn)(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(tokens), jcfg)
    params = transformer.params_from_numpy(np_params, cfg, "cpu")
    loss, got = _port_loss_and_grads(params, torch.tensor(tokens), cfg)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-4,
                               atol=2e-4)
    want = dict(_flat(want))
    assert got.keys() == want.keys()
    for path, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[path]),
                                   rtol=2e-4, atol=2e-4, err_msg=path)


def test_embedding_grad_of_repeated_ids_matches_jax():
    """The embedding's gradient when a few ids fill the batch (their rows'
    gradients summed over many positions) against the JAX ``loss_fn``'s,
    f32, at the tolerance above."""
    jcfg, cfg = _configs()
    np_params = _jax_params_numpy(jcfg)
    tokens = _tokens(6, (2, 65), vocab=3)
    _, want = jax.value_and_grad(jax_transformer.loss_fn)(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(tokens), jcfg)
    params = transformer.params_from_numpy(np_params, cfg, "cpu")
    _, got = _port_loss_and_grads(params, torch.tensor(tokens), cfg)
    np.testing.assert_allclose(got["embed"].numpy(),
                               np.asarray(want["embed"]), rtol=2e-4,
                               atol=2e-4)
    assert np.count_nonzero(np.abs(got["embed"].numpy()).sum(1)) == 3


def test_remat_gives_the_same_gradients():
    """Per-block checkpointing recomputes the blocks in the backward; the
    loss and every gradient stay the same."""
    _, cfg = _configs(use_flash=True, n_kv_heads=2)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(6),
                                     "cpu")
    tokens = torch.tensor(_tokens(7, (2, 25)))
    runs = [_port_loss_and_grads(
        {**params}, tokens, dataclasses.replace(cfg, remat=remat))
        for remat in (True, False)]
    (loss_r, grads_r), (loss_n, grads_n) = runs
    torch.testing.assert_close(loss_r, loss_n, rtol=1e-6, atol=1e-6)
    for path in grads_r:
        torch.testing.assert_close(grads_r[path], grads_n[path], rtol=1e-6,
                                   atol=1e-6, msg=path)


def test_loss_fn_under_no_grad_runs_without_remat():
    _, cfg = _configs()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(8),
                                     "cpu")
    tokens = torch.tensor(_tokens(9, (2, 17)))
    with torch.no_grad():
        loss = transformer.loss_fn(params, tokens, cfg)
    logits = transformer.apply(params, tokens[:, :-1], cfg)
    nll = -torch.log_softmax(logits, -1).gather(
        -1, tokens[:, 1:, None].long())[..., 0]
    torch.testing.assert_close(loss, nll.mean())
    assert loss.grad_fn is None


def test_transformer_causality():
    """Changing a future token must not affect earlier logits."""
    _, cfg = _configs(use_flash=True)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    tokens = torch.tensor(_tokens(1, (1, 16)))
    logits1 = transformer.apply(params, tokens, cfg)
    tokens2 = tokens.clone()
    tokens2[0, -1] = (tokens[0, -1] + 1) % 256
    logits2 = transformer.apply(params, tokens2, cfg)
    np.testing.assert_allclose(logits1[0, :-1].numpy(),
                               logits2[0, :-1].numpy(), rtol=1e-4, atol=1e-4)
    assert not torch.allclose(logits1[0, -1], logits2[0, -1])


def test_transformer_forward_shapes():
    _, cfg = _configs()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    logits = transformer.apply(params, torch.tensor(_tokens(2, (2, 16))), cfg)
    assert logits.shape == (2, 16, 256)
    assert logits.dtype == torch.float32
    x = transformer.backbone(params, torch.tensor(_tokens(2, (2, 16))), cfg)
    assert x.shape == (2, 16, 64)


def test_init_params_matches_jax_layout():
    jcfg, cfg = _configs(n_kv_heads=2, d_ff=96)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    jparams = _jax_params_numpy(jcfg)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
    assert transformer.param_shapes(cfg) == shapes
    assert transformer.num_params(params) == jax_transformer.num_params(
        jparams)
    # Same scales: dense weights ~ N(0, 1/fan_in), embed ~ N(0, 0.02^2).
    wq = params["blocks"]["attn"]["wq"]
    assert abs(wq.std().item() - 64 ** -0.5) < 0.01
    assert abs(params["embed"].std().item() - 0.02) < 0.002
    assert torch.equal(params["ln_f"], torch.ones(64))


def test_params_from_numpy_rejects_other_config():
    jcfg, _ = _configs()
    _, other = _configs(n_layers=3)
    with pytest.raises(ValueError, match="does not match"):
        transformer.params_from_numpy(_jax_params_numpy(jcfg), other, "cpu")


def test_cast_params_once_gives_identical_logits():
    """Casting the weights once for serving equals casting at every use."""
    _, cfg32 = _configs(use_flash=True)
    cfg16 = dataclasses.replace(cfg32, dtype=torch.bfloat16)
    params = transformer.init_params(cfg32, torch.Generator().manual_seed(3),
                                     "cpu")
    tokens = torch.tensor(_tokens(4, (2, 24)))
    per_use = transformer.apply(params, tokens, cfg16)
    once = transformer.apply(
        transformer.cast_params(params, torch.bfloat16), tokens, cfg16)
    assert torch.equal(per_use, once)
    assert torch.isfinite(once).all()


def test_entry_config_matches_jax_entry():
    """``ray_tpu_torch.entry`` runs ``__graft_entry__.entry``'s config."""
    cfg = port_entry.CONFIG
    assert (cfg.vocab_size, cfg.d_model, cfg.n_layers, cfg.n_heads,
            cfg.max_seq_len) == (32000, 512, 8, 8, 1024)
    assert cfg.dtype == torch.bfloat16 and cfg.use_flash and cfg.remat


def test_entry_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_entry.entry()


def test_logical_axes_match_jax():
    jcfg, cfg = _configs()
    assert transformer.logical_axes(cfg) == jax_transformer.logical_axes(jcfg)


# (mesh plan over 4 ranks, use_flash): the ring alone, the ring beside
# heads split over tensor, and heads split over tensor through the flash
# attention Function (its plain versions on the CPU).
MESH_CASES = {"seq4": (dict(data=1, seq=4), False),
              "seq2-tensor2": (dict(data=1, seq=2, tensor=2), False),
              "tensor4-flash": (dict(data=1, tensor=4), True)}


def _mesh_forward_body(np_params, tokens):
    """Per rank, each case: the logits of ``apply(..., mesh)`` gathered over
    the sequence chunks, and ``loss_fn(..., mesh)`` averaged over them."""
    from ray_tpu_torch.parallel import MeshConfig, build_mesh
    from ray_tpu_torch.parallel.spmd import all_gather
    from ray_tpu_torch.train.step import _Sharded
    out = {}
    tokens = torch.tensor(tokens)
    for name, (plan, use_flash) in MESH_CASES.items():
        mesh = build_mesh(MeshConfig(**plan), "cpu")
        cfg = TransformerConfig(**TINY, dtype=torch.float32,
                                use_flash=use_flash)
        sharded = _Sharded(cfg, mesh, None, 4, torch.device("cpu"))
        views = sharded.views(sharded.place(
            transformer.params_from_numpy(np_params, cfg, "cpu")))
        with torch.no_grad():
            logits = transformer.apply(views, tokens[:, :-1], cfg, mesh)
            loss = transformer.loss_fn(views, tokens, cfg, mesh)
            loss = all_gather(loss[None], mesh, "seq").mean()
        out[name] = (all_gather(logits, mesh, "seq", dim=1).numpy(),
                     loss.item())
    return out


@pytest.fixture(scope="module")
def mesh_results():
    jcfg, _ = _configs()
    np_params = _jax_params_numpy(jcfg)
    tokens = _tokens(11, (2, 65))
    got = run_spmd(_mesh_forward_body, 4, "cpu", 240.0, (np_params, tokens))
    params = jax.tree.map(jnp.asarray, np_params)
    want = (np.asarray(jax_transformer.apply(params, tokens[:, :-1], jcfg)),
            float(jax_transformer.loss_fn(params, jnp.asarray(tokens), jcfg)))
    return got, want


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_apply_and_loss_with_mesh_match_jax(mesh_results, case):
    """``apply``/``loss_fn`` with a mesh (sequence chunks through ring
    attention, heads split over tensor) against the JAX model run whole."""
    got, (want_logits, want_loss) = mesh_results
    logits, loss = got[case]
    np.testing.assert_allclose(logits, want_logits, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(loss, want_loss, rtol=2e-5)


def test_mesh_none_is_the_one_device_model():
    _, cfg = _configs(use_flash=True)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(12),
                                     "cpu")
    tokens = torch.tensor(_tokens(13, (2, 17)))
    torch.testing.assert_close(
        transformer.apply(params, tokens, cfg, mesh=None),
        transformer.apply(params, tokens, cfg), rtol=0, atol=0)
