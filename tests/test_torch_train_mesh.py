"""The port's trainer on a mesh of data x model shards against the JAX
trainer on its 8-device mesh, on `test-tiny` in fp32 on the CPU.

The port's mesh names the CPU eight times (`make_mesh(devices=["cpu"] *
8)`, one process, as `parallel/sharding.py` makes meshes); the JAX
trainer's runs over the eight virtual devices of `tests/conftest.py`.
Its seeded flax init goes across
through `models/convert.py::vision_params_from_flax` and is cut onto the
port's shards by `ModelShards.scatter`. Tolerances are
`tests/test_torch_train.py`'s.

The port cuts attention by whole heads, so its model axis must divide
the heads. test-tiny has 4, so the 1 x 8 mesh of `tests/test_train.py`
runs test-tiny with 8 heads of 8 (`TINY8`), and test-tiny itself on 1 x 8
raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverso_tpu.config import MODEL_PRESETS, MeshConfig
from reverso_tpu.ops.norm import l2_normalize as jax_l2_normalize
from reverso_tpu.parallel import make_mesh as jax_make_mesh
from reverso_tpu.train import ClipTrainer as JaxTrainer
from reverso_tpu.train import siglip_loss as jax_siglip_loss
from reverso_tpu_torch.config import MeshConfig as PortMeshConfig
from reverso_tpu_torch.models.convert import vision_params_from_flax
from reverso_tpu_torch.parallel import make_mesh
from reverso_tpu_torch.train import ClipTrainer
from reverso_tpu_torch.train.checkpoint import restore_train_state, save_train_state

TINY = dataclasses.replace(MODEL_PRESETS["test-tiny"], dtype="float32")
TINY8 = dataclasses.replace(TINY, num_heads=8)
LR = 1e-3
LOSS_TOL, GRAD_TOL = 1e-6, 1e-4
_JAX = {}


def _views(seed: int = 0, n: int = 8):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
    return a, a + 0.01 * rng.standard_normal(a.shape).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_mesh(sizes):
    return make_mesh(PortMeshConfig(axis_sizes=sizes), devices=["cpu"] * (sizes[0] * sizes[1]))


def _jax_trainer(cfg, sizes, fresh: bool = False):
    """The JAX trainer on its 8-device mesh of `sizes` (seed 3), shared by
    the tests that only read it."""
    key = (cfg.num_heads, sizes)
    if fresh or key not in _JAX:
        jt = JaxTrainer(cfg, jax_make_mesh(MeshConfig(axis_sizes=sizes)),
                        learning_rate=LR, seed=3)
        if fresh:
            return jt
        _JAX[key] = jt
    return _JAX[key]


def _port_from(jt, cfg, sizes, seed: int = 11) -> ClipTrainer:
    """A port trainer on a CPU mesh of `sizes` holding the JAX trainer's
    initial params."""
    tr = ClipTrainer(cfg, _port_mesh(sizes), learning_rate=LR, seed=seed)
    tr.shards.scatter(vision_params_from_flax(_np_tree(jt.state.params), cfg))
    return tr


def _jax_value_and_grad(jt, a, b):
    """jax.value_and_grad of the JAX trainer's loss on its sharded params,
    the views wrap-padded and sharded by its `shard_batch`, pad rows masked
    as its step masks them."""
    def loss_fn(params, t, b_, va, vb, valid):
        ea = jax_l2_normalize(jt.module.apply({"params": params}, va).astype(jnp.float32))
        eb = jax_l2_normalize(jt.module.apply({"params": params}, vb).astype(jnp.float32))
        return jax_siglip_loss(ea, eb, t, b_, valid)

    va, vb = jt.shard_batch(a), jt.shard_batch(b)
    valid = (jnp.arange(va.shape[0]) < a.shape[0]).astype(jnp.float32)
    return jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1, 2)))(
        jt.state.params, jt.state.t, jt.state.b, va, vb, valid)


@pytest.mark.parametrize("cfg,sizes,n", [(TINY, (4, 2), 8), (TINY8, (1, 8), 8),
                                         (TINY, (4, 2), 6)],
                         ids=["4x2", "1x8-8heads", "4x2-B6-wrap-padded"])
def test_one_step_matches_jax_on_its_mesh(cfg, sizes, n):
    """One value_and_grad step: the loss and every whole gradient (the
    converter's names and layouts), t's and b's. B = 6 over a data axis
    of 4 wrap-pads to 8 with the pad rows masked out of the loss."""
    jt = _jax_trainer(cfg, sizes)
    a, b = _views(0, n)
    want_loss, (gp, gt, gb) = _jax_value_and_grad(jt, a, b)
    tr = _port_from(jt, cfg, sizes)
    va = tr.shard_batch(a)
    assert va.n == -(-n // sizes[0]) * sizes[0]
    np.testing.assert_array_equal(torch.cat(va.parts).numpy(),
                                  np.asarray(jt.shard_batch(a)))
    loss, grads = tr.value_and_grad(a, b)
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL * max(1.0, abs(float(want_loss)))
    want = vision_params_from_flax(_np_tree(gp), cfg)
    want.update(t=torch.tensor(np.asarray(gt)), b=torch.tensor(np.asarray(gb)))
    assert set(want) == set(grads)
    # the attention pool's k_proj bias has a zero gradient in exact
    # arithmetic: each leaf's scale is floored at 1e-6 of the largest
    floor = 1e-6 * max(float(w.abs().max()) for w in want.values())
    for name, g in grads.items():
        w = want[name].double()
        assert g.shape == w.shape, name
        scale = max(float(w.abs().max()), floor)
        err = float((g.double() - w).abs().max())
        assert err <= GRAD_TOL * scale, (name, err, scale)


def test_three_adamw_steps_match_jax_on_its_mesh():
    """Three steps on 4 x 2 against the JAX trainer's `train_step` on its
    4 x 2 mesh: the losses, and every parameter afterwards within the
    bound `tests/test_torch_train.py::test_three_adamw_steps_match_optax`
    derives."""
    jt = _jax_trainer(TINY, (4, 2), fresh=True)
    tr = _port_from(jt, TINY, (4, 2))
    a, b = _views(1)
    _, (gp, _, _) = _jax_value_and_grad(jt, a, b)
    first = vision_params_from_flax(_np_tree(gp), TINY)
    want_losses = [jt.train_step(a, b) for _ in range(3)]
    losses = [tr.train_step(a, b) for _ in range(3)]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_TOL, atol=LOSS_TOL)
    want = vision_params_from_flax(_np_tree(jt.state.params), TINY)
    want.update(t=torch.tensor(np.asarray(jt.state.t)), b=torch.tensor(np.asarray(jt.state.b)))
    state = tr.state
    got = dict(state.params, t=state.t, b=state.b)
    assert set(got) == set(want)
    for name, p in got.items():
        err = (p.detach().double() - want[name].double()).abs()
        g = first[name].double().abs() if name in first else torch.ones_like(err)
        bound = 2e-6 + 6 * LR * GRAD_TOL * float(g.max()) / g.clamp(min=1e-30)
        assert (err <= bound.clamp(max=3 * LR * 1.01)).all(), (name, float(err.max()))
    assert int(tr.step) == int(jax.device_get(jt.state.step)) == 3


def test_one_by_one_mesh_is_the_one_device_trainer():
    """A 1 x 1 mesh trains bit for bit as `mesh=None`: the losses of three
    steps, every parameter and AdamW moment afterwards."""
    a, b = _views(2)
    one = ClipTrainer(TINY, learning_rate=LR, seed=5, device="cpu")
    tm = ClipTrainer(TINY, _port_mesh((1, 1)), learning_rate=LR, seed=5)
    assert [one.train_step(a, b) for _ in range(3)] == [tm.train_step(a, b) for _ in range(3)]
    s1, s2 = one.state, tm.state
    assert all(torch.equal(s1.params[n], s2.params[n]) for n in s1.params)
    assert s1.opt_state.keys() == s2.opt_state.keys()
    assert all(torch.equal(s1.opt_state[n][f], s2.opt_state[n][f])
               for n in s1.opt_state for f in ("step", "exp_avg", "exp_avg_sq"))
    assert torch.equal(s1.t, s2.t) and torch.equal(s1.b, s2.b)


@pytest.mark.parametrize("cfg,sizes", [(TINY, (4, 2)), (TINY8, (1, 8))],
                         ids=["4x2", "1x8-8heads"])
def test_shard_layout_matches_jax_partition_spec(cfg, sizes):
    """Each parameter's pieces against the JAX trainer's sharded leaf: a
    leaf the spec cuts over "model" has one piece per model index, of the
    shape of the JAX leaf's shard (in the converter's layouts), piece m on
    the mesh's device at (data 0, model m), and the module holds None in
    its place; a replicated leaf is the module's own parameter, whole, on
    the mesh's first device. `scatter` then `gather` gives the whole
    tensors back bit for bit."""
    jt = _jax_trainer(cfg, sizes)
    tr = ClipTrainer(cfg, _port_mesh(sizes), seed=0)
    shapes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jt.state.params)[0]:
        names = [k.key for k in path]
        mods = [f"blocks.{m[5:]}" if m.startswith("block") and m[5:].isdigit() else m
                for m in names[:-1]]
        name = ".".join(mods + [{"kernel": "weight", "scale": "weight"}.get(names[-1],
                                                                           names[-1])])
        shard = tuple(leaf.sharding.shard_shape(leaf.shape))
        layout = {2: (1, 0), 4: (3, 2, 0, 1)}.get(leaf.ndim, range(leaf.ndim))
        shapes[name] = (tuple(shard[i] for i in layout), shard != tuple(leaf.shape))
    own = dict(tr.module.named_parameters())
    assert set(shapes) == set(tr.shards.pieces)
    for name, ps in tr.shards.pieces.items():
        shape, cut = shapes[name]
        assert (tr.shards.dims[name] is not None) == cut, name
        assert all(tuple(p.shape) == shape for p in ps), (name, [p.shape for p in ps], shape)
        if cut:
            assert len(ps) == sizes[1] and name not in own
            assert [p.device for p in ps] == list(tr.mesh.devices[0])
        else:
            assert len(ps) == 1 and ps[0] is own[name] and ps[0].device == tr.mesh.first
    # scatter and gather between whole tensors by name and the pieces
    whole = vision_params_from_flax(_np_tree(jt.state.params), cfg)
    tr.shards.scatter(whole)
    back = tr.shards.gather()
    assert set(back) == set(whole) and all(torch.equal(back[n], whole[n]) for n in whole)


@pytest.mark.parametrize("cfg,what", [(TINY, "4 heads"),
                                      (dataclasses.replace(TINY8, mlp_ratio=3.0625),
                                       "196 hidden units")])
def test_model_axis_must_divide_heads_and_hidden(cfg, what):
    with pytest.raises(ValueError, match=f"8 shards does not divide the {what}"):
        ClipTrainer(cfg, _port_mesh((1, 8)))


@pytest.mark.parametrize("sizes", [(4, 2), (2, 4)], ids=["same-mesh", "2x4"])
def test_checkpoint_resumes_across_meshes(tmp_path, sizes):
    """Saved on 4 x 2 after a step; restored with `mesh=` into a trainer of
    another seed on the same mesh, its next step's loss equals the
    uninterrupted run's bit for bit; restored on 2 x 4, every parameter and
    AdamW moment equals bit for bit."""
    a, b = _views(4)
    t1 = ClipTrainer(TINY, _port_mesh((4, 2)), learning_rate=LR, seed=1)
    t1.train_step(a, b)
    path = str(tmp_path / "state.pt")
    save_train_state(path, t1.state)
    mesh = _port_mesh(sizes)
    t2 = ClipTrainer(TINY, mesh, learning_rate=LR, seed=99)
    t2.state = restore_train_state(path, t2.state, mesh=mesh)
    assert int(t2.step) == 1
    s1, s2 = t1.state, t2.state
    assert all(torch.equal(s1.params[n], s2.params[n]) for n in s1.params)
    assert s1.opt_state.keys() == s2.opt_state.keys()
    assert all(torch.equal(s1.opt_state[n][f], s2.opt_state[n][f])
               for n in s1.opt_state for f in ("step", "exp_avg", "exp_avg_sq"))
    if sizes == (4, 2):
        assert t1.train_step(a, b) == t2.train_step(a, b)
