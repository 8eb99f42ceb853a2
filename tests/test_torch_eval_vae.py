"""The port's skeleton topology, FGD eval VAE, face VQ-VAE and their train steps against the JAX package, on the CPU.

The weights are the port's seeded initialization written as a flax tree
(``bridge.FlaxLayout.to_flax``), with the GroupNorm scales and biases and
the face codebook perturbed (their initial 1/0 and [0, 2/256) values prove
nothing); JAX applies that tree and the port reads it back through
``bridge.eval_vae_from_flax`` / ``face_vqvae_from_flax``. The skeleton
convs' raw kernels are non-zero where their mask is zero, so the mask is
applied on both sides. Tolerances: the topology tables equal; the eval VAE
at full ``EvalVAEConfig`` width on (2, 32, 330) within rel 1e-5 (its
forward, ``map2latent`` and ``decode``); ``legacy_vq``'s indices equal
(an exact tie to the lower index), its loss, perplexity and
straight-through gradient within rel 1e-5; one Adam step of each model
against ``ae_trainer`` + optax: the loss within rel 1e-5, the first moment
(a tenth of the gradient) within rel 1e-4, the parameters within rel 1e-5
where the gradient is above 1e-4, far above Adam's eps."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from syntalker_tpu.models import eval_vae as JE
from syntalker_tpu.models import skeleton as JK
from syntalker_tpu.ops.smplx import PARENTS
from syntalker_tpu.train import ae_trainer as JT
from syntalker_tpu.train import state as JS
from syntalker_tpu_torch import bridge
from syntalker_tpu_torch.models import eval_vae as PE
from syntalker_tpu_torch.models import skeleton as PK
from syntalker_tpu_torch.train import ae_trainer as PT
from syntalker_tpu_torch.train import optim
from syntalker_tpu_torch.train.state import create_train_state

from test_torch_train_rvq import close
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

REL = 1e-5
LR = 1e-3


def perturb_norms(tree, g):
    """GroupNorm scale/bias leaves (under ``norm``) replaced by random values."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb_norms(v, g) if k != "norm" else {n: (1.0 if n == "scale" else 0.0) +
                                                               g.normal(0, 0.2, a.shape).astype(np.float32)
                                                               for n, a in v.items()}
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def eval_vae():
    """(flax params, the port's VAESKConv read from them, JAX module)."""
    torch.manual_seed(0)
    model = PE.VAESKConv()
    params = perturb_norms(bridge.FlaxLayout(model).to_flax(dict(model.named_parameters())), np.random.default_rng(1))
    return params, bridge.eval_vae_from_flax(params, device="cpu"), JE.VAESKConv(JE.EvalVAEConfig())


@pytest.fixture(scope="module")
def face():
    torch.manual_seed(2)
    model = PE.VQVAEConvZero()
    params = bridge.FlaxLayout(model).to_flax(dict(model.named_parameters()))
    params["codebook"] = np.random.default_rng(3).normal(0, 0.5, params["codebook"].shape).astype(np.float32)
    return params, bridge.face_vqvae_from_flax(params, device="cpu"), JE.VQVAEConvZero()


def test_topology_tables_are_jaxs():
    edges = PK.build_edge_topology(PARENTS.tolist())
    assert edges == JK.build_edge_topology(PARENTS.tolist())
    np.testing.assert_array_equal(PK.calc_edge_mat(edges), JK.calc_edge_mat(edges))
    for d in (1, 2):
        assert [list(map(int, n)) for n in PK.find_neighbor(edges, d)] == \
               [list(map(int, n)) for n in JK.find_neighbor(edges, d)]
    topo = edges
    for last in (False, False, False, True):
        pp, jp = PK.skeleton_pooling_plan(topo, last_pool=last), JK.skeleton_pooling_plan(topo, last_pool=last)
        assert (pp.pooling_list, pp.new_edges) == (jp.pooling_list, jp.new_edges)
        np.testing.assert_array_equal(PK.pooling_matrix(pp, 6, len(topo)), JK.pooling_matrix(jp, 6, len(topo)))
        np.testing.assert_array_equal(PK.unpooling_matrix(pp, 6), JK.unpooling_matrix(jp, 6))
        neigh = PK.find_neighbor(topo, 2)
        np.testing.assert_array_equal(PK.skeleton_conv_mask(neigh, 6, 12, 4), JK.skeleton_conv_mask(neigh, 6, 12, 4))
        topo = pp.new_edges or topo


def test_eval_vae_matches_jax_at_full_width(eval_vae):
    params, port, jmod = eval_vae
    assert port.encoder.out_dim == JE.EvalVAEConfig().latent_dim and not hasattr(port.decoder, "proj")
    kernel = port.encoder.layer[0].conv
    assert (kernel.kernel * (1 - kernel.mask)).abs().max() > 0  # masked-out entries carried, not zeroed
    x = np.random.default_rng(4).normal(0, 0.5, (2, 32, 330)).astype(np.float32)
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.as_tensor(x))
        z = port.map2latent(torch.as_tensor(x))
        rec = port.decode(z)
    assert z.shape == (2, 2, 240)
    close(got["poses_feat"].numpy(), np.asarray(ref["poses_feat"]), REL, msg="poses_feat")
    close(got["rec_pose"].numpy(), np.asarray(ref["rec_pose"]), REL, msg="rec_pose")
    close(z.numpy(), np.asarray(ref["poses_feat"]), REL, msg="map2latent")
    close(rec.numpy(), np.asarray(ref["rec_pose"]), REL, msg="decode")
    assert bridge.FlaxLayout(port).to_flax(dict(port.named_parameters())).keys() == params.keys()


def test_face_vqvae_matches_jax(face):
    params, port, jmod = face
    x = np.random.default_rng(5).normal(0, 1.0, (2, 32, 106)).astype(np.float32)
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.as_tensor(x))
        idx = port.map2index(torch.as_tensor(x))
    jidx = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), method="map2index"))
    np.testing.assert_array_equal(idx.numpy(), jidx)
    assert len(np.unique(jidx)) > 4
    for k in ("rec_pose", "embedding_loss", "perplexity", "poses_feat"):
        close(got[k].numpy(), np.asarray(ref[k]), REL, msg=k)
    with torch.no_grad():
        close(port.map2latent(torch.as_tensor(x)).numpy(),
              np.asarray(jmod.apply({"params": params}, jnp.asarray(x), method="map2latent")), REL)
        close(port.decode_indices(idx).numpy(),
              np.asarray(jmod.apply({"params": params}, jnp.asarray(jidx), method="decode_indices")), REL)


def test_legacy_vq_matches_jax_with_ties_and_gradient():
    g = np.random.default_rng(6)
    codebook = g.normal(size=(32, 8)).astype(np.float32)
    codebook[20] = codebook[7]  # a duplicated code: the tie goes to index 7
    z = g.normal(size=(2, 16, 8)).astype(np.float32)
    z[0, 3] = codebook[7]
    w = g.normal(size=z.shape).astype(np.float32)

    def jax_obj(zz):
        loss, z_st, _, _ = JE.legacy_vq(zz, jnp.asarray(codebook))
        return loss + jnp.sum(z_st * w)

    jl, jz, ji, jp = JE.legacy_vq(jnp.asarray(z), jnp.asarray(codebook))
    zt = torch.as_tensor(z).requires_grad_(True)
    pl, pz, pi, pp = PE.legacy_vq(zt, torch.as_tensor(codebook))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert pi[0, 3] == 7
    close(pl.detach().numpy(), np.asarray(jl), REL)
    close(pz.detach().numpy(), np.asarray(jz), REL)
    close(pp.detach().numpy(), np.asarray(jp), REL)
    (grad,) = torch.autograd.grad(pl + (pz * torch.as_tensor(w)).sum(), zt)
    close(grad.numpy(), np.asarray(jax.grad(jax_obj)(jnp.asarray(z))), REL)


def adam_step_check(params, jmod, port_module, make_jax_step, make_port_step, batch):
    """One Adam step of each package from the same weights on the same batch."""
    jstate = JS.create_train_state(params, optax.adam(LR), jax.random.PRNGKey(0))
    jstate, jm = jax.jit(make_jax_step(jmod, optax.adam(LR)))(jstate, jnp.asarray(batch))
    tx = optim.adam(LR)
    pstate = create_train_state(port_module, tx, torch.Generator().manual_seed(0))
    pstate, pm = make_port_step(port_module, tx)(pstate, torch.as_tensor(batch))
    for k in pm:
        close(pm[k].numpy(), np.asarray(jm[k]), REL, msg=k)
    layout = pstate.layout
    mu_p = layout.to_flax(pstate.opt_state[0].mu)
    mu_j = jax.tree.map(np.asarray, jstate.opt_state[0].mu)
    new_p, new_j = layout.to_flax(pstate.params), jax.tree.map(np.asarray, jstate.params)
    flat = jax.tree_util.tree_flatten_with_path(mu_j)[0]
    assert len(flat) == len(layout.leaves)
    for path, mj in flat:
        keys = [p.key for p in path]
        mp, pp, pj = mu_p, new_p, new_j
        for k in keys:
            mp, pp, pj = mp[k], pp[k], pj[k]
        close(mp, mj, 1e-4, msg="/".join(keys))
        # |g| = 10 |mu| far above eps and rounding noise (a conv bias before GroupNorm has a zero gradient
        # up to rounding): there the step is lr·sign(g)
        far = 10 * np.abs(mj) > 1e-4
        close(pp[far], pj[far], REL, msg="/".join(keys))


def test_eval_vae_adam_step_matches_optax(eval_vae):
    params, _, jmod = eval_vae
    port = bridge.eval_vae_from_flax(params, device="cpu")
    batch = np.random.default_rng(7).normal(0, 0.5, (2, 32, 330)).astype(np.float32)
    adam_step_check(params, jmod, port, JT.make_eval_vae_train_step, PT.make_eval_vae_train_step, batch)


def test_face_vqvae_adam_step_matches_optax(face):
    params, _, jmod = face
    port = bridge.face_vqvae_from_flax(params, device="cpu")
    batch = np.random.default_rng(8).normal(0, 1.0, (2, 32, 106)).astype(np.float32)
    adam_step_check(params, jmod, port, JT.make_face_vqvae_train_step, PT.make_face_vqvae_train_step, batch)
