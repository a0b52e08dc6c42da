"""The port's SigLIP trainer (`reverso_tpu_torch.train`) against the JAX
package's, on `test-tiny` in fp32 (W 64, 2 blocks, 4 heads) on the CPU.

The JAX trainer runs on a one-device mesh, as tests/test_train.py's
single-device trainer does; its seeded flax init goes across through
`models/convert.py::vision_params_from_flax`, so both trainers start from
the same weights and see the same numpy views.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverso_tpu.config import MODEL_PRESETS, MeshConfig
from reverso_tpu.ops.norm import l2_normalize as jax_l2_normalize
from reverso_tpu.parallel import make_mesh
from reverso_tpu.train import ClipTrainer as JaxTrainer
from reverso_tpu.train import param_partition_spec as jax_partition_spec
from reverso_tpu.train import siglip_loss as jax_siglip_loss
from reverso_tpu_torch.models.convert import vision_params_from_flax
from reverso_tpu_torch.train import ClipTrainer, param_partition_spec, siglip_loss
from reverso_tpu_torch.train.checkpoint import restore_train_state, save_train_state

TINY = dataclasses.replace(MODEL_PRESETS["test-tiny"], dtype="float32")
LR = 1e-3
# fp32 on both sides, sums in another order: the loss within 1e-6 of it,
# each gradient within 1e-4 of its leaf's largest value (the backward
# runs two towers, the pool and the loss deep, in fp32)
LOSS_TOL, GRAD_TOL = 1e-6, 1e-4


def _views(seed: int = 0, n: int = 8):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
    return a, a + 0.01 * rng.standard_normal(a.shape).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_trainer():
    mesh = make_mesh(MeshConfig(axis_sizes=(1, 1)), devices=jax.devices()[:1])
    return JaxTrainer(TINY, mesh, learning_rate=LR, seed=3)


def _port_from(jt) -> ClipTrainer:
    """A port trainer on the CPU holding the JAX trainer's initial params."""
    tr = ClipTrainer(TINY, learning_rate=LR, seed=11, device="cpu")
    tr.module.load_state_dict(vision_params_from_flax(_np_tree(jt.state.params), TINY))
    return tr


def test_siglip_loss_matches_jax():
    rng = np.random.default_rng(4)
    ea, eb = (rng.standard_normal((6, 16)).astype(np.float32) for _ in range(2))
    t, b = np.float32(np.log(10.0)), np.float32(-5.0)
    valid = np.array([1, 1, 1, 1, 0, 0], np.float32)
    for v in (None, valid):
        want = float(jax_siglip_loss(jnp.asarray(ea), jnp.asarray(eb), jnp.asarray(t),
                                     jnp.asarray(b), None if v is None else jnp.asarray(v)))
        got = float(siglip_loss(torch.from_numpy(ea), torch.from_numpy(eb), torch.tensor(t),
                                torch.tensor(b), None if v is None else torch.from_numpy(v)))
        assert abs(got - want) <= LOSS_TOL * max(1.0, abs(want))
    e = torch.eye(4, 8)
    t10, b5 = torch.log(torch.tensor(10.0)), torch.tensor(-5.0)
    assert float(siglip_loss(e, e, t10, b5)) < float(siglip_loss(e, e.flip(0), t10, b5))


def test_one_step_loss_and_grads_match_jax(jax_trainer):
    """One value_and_grad step: the loss, every tower gradient mapped
    through the converter's names and layouts, and t's and b's."""
    jt = jax_trainer
    a, b = _views()

    def loss_fn(params, t, b_, va, vb, valid):
        ea = jax_l2_normalize(jt.module.apply({"params": params}, va).astype(jnp.float32))
        eb = jax_l2_normalize(jt.module.apply({"params": params}, vb).astype(jnp.float32))
        return jax_siglip_loss(ea, eb, t, b_, valid)

    valid = jnp.ones((a.shape[0],), jnp.float32)
    want_loss, (gp, gt, gb) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1, 2)))(
        jt.state.params, jt.state.t, jt.state.b, a, b, valid)
    tr = _port_from(jt)
    loss, grads = tr.value_and_grad(a, b)
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL * max(1.0, abs(float(want_loss)))
    want = vision_params_from_flax(_np_tree(gp), TINY)
    want.update(t=torch.tensor(np.asarray(gt)), b=torch.tensor(np.asarray(gb)))
    assert set(want) == set(grads)
    # a leaf whose gradient is zero in exact arithmetic (the attention
    # pool's k_proj bias: the pool has no RoPE, and a bias on the keys adds
    # one constant to a query's scores) holds rounding noise near 1e-12 in
    # both packages: each leaf's scale is floored at 1e-6 of the largest
    # gradient anywhere
    floor = 1e-6 * max(float(w.abs().max()) for w in want.values())
    for name, g in grads.items():
        w = want[name].double()
        scale = max(float(w.abs().max()), floor)
        err = float((g.double() - w).abs().max())
        assert err <= GRAD_TOL * scale, (name, err, scale)


def test_three_adamw_steps_match_optax():
    """Three steps of torch's AdamW against optax.adamw (weight decay on the
    tower, none on t and b): the losses, and every parameter afterwards.

    Adam's step lr * m / (sqrt(v) + eps) is about lr * sign(g) whatever the
    size of the gradient g, so a relative difference r in g moves the step
    by about 2 r lr. One step's gradients agree to GRAD_TOL of their leaf's
    largest (the test above), so an element with first gradient g may
    differ by 3 steps x 2 lr x GRAD_TOL x leaf max / |g|, plus 2e-6 for
    the rounding of the parameters. Where g is zero in exact arithmetic
    (the attention pool's k_proj bias: the pool has no RoPE, and a bias on
    the keys adds one constant to a query's scores) or near it, the step
    follows the sign of rounding noise in either package, and the bound is
    the one Adam itself gives: 3 steps x lr x 1.01."""
    mesh = make_mesh(MeshConfig(axis_sizes=(1, 1)), devices=jax.devices()[:1])
    jt = JaxTrainer(TINY, mesh, learning_rate=LR, seed=3)
    tr = _port_from(jt)
    a, b = _views(1)

    def loss_fn(params, t, b_, va, vb):
        ea = jax_l2_normalize(jt.module.apply({"params": params}, va).astype(jnp.float32))
        eb = jax_l2_normalize(jt.module.apply({"params": params}, vb).astype(jnp.float32))
        return jax_siglip_loss(ea, eb, t, b_, jnp.ones((va.shape[0],), jnp.float32))

    first = vision_params_from_flax(_np_tree(jax.grad(loss_fn)(
        jt.state.params, jt.state.t, jt.state.b, a, b)), TINY)
    want_losses = [jt.train_step(a, b) for _ in range(3)]
    losses = [tr.train_step(a, b) for _ in range(3)]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_TOL, atol=LOSS_TOL)
    want = vision_params_from_flax(_np_tree(jt.state.params), TINY)
    want.update(t=torch.tensor(np.asarray(jt.state.t)), b=torch.tensor(np.asarray(jt.state.b)))
    got = dict(tr.module.named_parameters())
    got.update(t=tr.t, b=tr.b)
    for name, p in got.items():
        err = (p.detach().double() - want[name].double()).abs()
        g = first[name].double().abs() if name in first else torch.ones_like(err)
        bound = 2e-6 + 6 * LR * GRAD_TOL * float(g.max()) / g.clamp(min=1e-30)
        assert (err <= bound.clamp(max=3 * LR * 1.01)).all(), (name, float(err.max()))
    assert int(tr.step) == int(jax.device_get(jt.state.step)) == 3


def test_param_partition_spec_matches_jax():
    """Leaf by leaf: the JAX spec of each flax leaf, in the port's layout
    (Dense kernels [in, out] become weights [out, in], so a 2-D spec is
    reversed), under the converter's name."""
    from reverso_tpu.models.vit import VisionTransformer as JaxViT
    from jax.sharding import PartitionSpec as P

    params = JaxViT(TINY).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    spec = jax_partition_spec(params)
    flat, _ = jax.tree_util.tree_flatten_with_path(spec, is_leaf=lambda x: isinstance(x, P))
    leaves = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    want = {}
    for path, s in flat:
        names = [k.key for k in path]
        mods = [f"blocks.{m[5:]}" if m.startswith("block") and m[5:].isdigit() else m
                for m in names[:-1]]
        leaf = {"kernel": "weight", "scale": "weight"}.get(names[-1], names[-1])
        arr = leaves[path]
        s = tuple(s)
        want[".".join(mods + [leaf])] = tuple(reversed(s)) if arr.ndim == 2 and s else s
    tr = ClipTrainer(TINY, device="cpu")
    got = param_partition_spec(dict(tr.module.named_parameters()))
    assert got == want
    assert got["blocks.0.attn.q_proj.weight"] == ("model", None)
    assert got["blocks.1.mlp.fc2.weight"] == (None, "model")


def test_checkpoint_roundtrip_bit_for_bit(tmp_path):
    """Save after a step, restore into a trainer of another seed: params,
    AdamW state, t, b and step equal bit for bit, and the next step gives
    the same loss in both."""
    t1 = ClipTrainer(TINY, learning_rate=LR, device="cpu")
    a, b = _views(2)
    t1.train_step(a, b)
    path = str(tmp_path / "ckpt" / "state.pt")
    save_train_state(path, t1.state)
    t2 = ClipTrainer(TINY, learning_rate=LR, seed=99, device="cpu")
    assert not torch.equal(t2.module.blocks[0].mlp.fc1.weight, t1.module.blocks[0].mlp.fc1.weight)
    t2.state = restore_train_state(path, t2.state)
    assert int(t2.step) == 1
    for (n1, p1), (n2, p2) in zip(t1.module.named_parameters(), t2.module.named_parameters()):
        assert n1 == n2 and torch.equal(p1, p2), n1
    assert torch.equal(t1.t, t2.t) and torch.equal(t1.b, t2.b)
    s1, s2 = t1.opt.state_dict()["state"], t2.opt.state_dict()["state"]
    assert s1.keys() == s2.keys()
    for key in s1:
        for field in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s1[key][field], s2[key][field]), (key, field)
    assert t1.train_step(a, b) == t2.train_step(a, b)
    with pytest.raises(FileExistsError):
        save_train_state(path, t1.state, force=False)


def test_trainer_learns_and_refuses_meshes(tmp_path):
    """One device: five steps lower the loss, with optax's weight-decay
    mask. A mesh (the name is kept from when meshes raised): a 2 x 2 mesh
    on the CPU trains, and a checkpoint of it restores onto a 1 x 4 mesh
    with `mesh=`, equal bit for bit."""
    from reverso_tpu_torch.config import MeshConfig as PortMeshConfig
    from reverso_tpu_torch.parallel import make_mesh as port_make_mesh

    tr = ClipTrainer(TINY, learning_rate=1e-3, device="cpu", use_flash=True)
    a, b = _views(3)
    losses = [tr.train_step(a, b) for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert int(tr.step) == 5
    # optax's mask: weight decay on the tower, none on t and b
    tower, scalars = tr.opt.param_groups
    assert tower["weight_decay"] == 1e-4 and scalars["weight_decay"] == 0.0
    assert scalars["params"] == [tr.t, tr.b]
    assert len(tower["params"]) == len(list(tr.module.parameters()))
    mesh = port_make_mesh(PortMeshConfig(axis_sizes=(2, 2)), devices=["cpu"] * 4)
    tm = ClipTrainer(TINY, mesh, learning_rate=1e-3, seed=0)
    mesh_losses = [tm.train_step(a, b) for _ in range(3)]
    assert np.isfinite(mesh_losses).all() and mesh_losses[-1] < mesh_losses[0], mesh_losses
    path = str(tmp_path / "state.pt")
    save_train_state(path, tm.state)
    other = port_make_mesh(PortMeshConfig(axis_sizes=(1, 4)), devices=["cpu"] * 4)
    t2 = ClipTrainer(TINY, other, learning_rate=1e-3, seed=7)
    t2.state = restore_train_state(path, t2.state, mesh=other)
    assert int(t2.step) == 3
    want, got = tm.state, t2.state
    assert all(torch.equal(want.params[n], got.params[n]) for n in want.params)
    assert all(torch.equal(want.opt_state[n][f], got.opt_state[n][f])
               for n in want.opt_state for f in want.opt_state[n])
