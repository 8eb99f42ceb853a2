"""The port's HumanML3D evaluation pieces against the JAX package's, f32 on the CPU.

- the numpy metrics on the same seeded arrays, to 1e-6 (they are the same
  float64 numpy code, and MultiModality and Diversity take the same
  ``default_rng(seed)`` draws);
- the BiGRU oracle's two towers on the committed ``weights/t2m_oracle/bigru.npz``
  bridged into the port, at lengths that include ``m_lens // 4 == 0``, a
  frame count that is not a multiple of 4 and variable caption lengths:
  1e-5 relative (f32 sums in another order; the GRU runs 10 steps);
- ``T2MEvaluator.from_artifact`` with the default path and a missing one,
  and the bridge's two directions on the artifact;
- ``make_t2m_oracle_train_step`` (symmetric InfoNCE) one step at a
  small width against JAX's, with optax's Adam through ``train/optim.py``:
  the losses, and the params where JAX's gradient (read through SGD at a
  rate of 1e4) stands above f32 noise, with the tolerances of
  ``test_torch_train_extras.run_steps``."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syntalker_tpu.eval import t2m as J
from syntalker_tpu_torch import bridge
from syntalker_tpu_torch.eval import t2m as P

from test_torch_text import perturbed
from test_torch_train_extras import run_steps
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

METRIC_REL = 1e-6
TOWER_REL = 1e-5


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def metric_inputs():
    g = np.random.default_rng(0)
    text, motion = g.normal(size=(12, 8)), g.normal(size=(12, 8))
    motion[:4] = text[:4] + 0.1 * g.normal(size=(4, 8))  # a few close pairs: the hits are not all misses
    return {"text": text.astype(np.float32), "motion": motion.astype(np.float32),
            "mm": g.normal(size=(5, 7, 8)).astype(np.float32), "reps": g.normal(size=(20, 3))}


METRICS = {
    "euclidean_distance_matrix": lambda m, x: m.euclidean_distance_matrix(x["text"], x["motion"]),
    "calculate_top_k": lambda m, x: m.calculate_top_k(np.argsort(m.euclidean_distance_matrix(x["text"], x["motion"]),
                                                                 axis=1), 3),
    "matching_and_r_precision": lambda m, x: np.r_[m.matching_and_r_precision(x["text"], x["motion"])[0],
                                                   m.matching_and_r_precision(x["text"], x["motion"])[1]],
    "calculate_diversity": lambda m, x: [m.calculate_diversity(x["motion"], 9, seed=s) for s in (0, 3)],
    "calculate_diversity_with_replacement": lambda m, x: m.calculate_diversity(x["motion"], 30, seed=1),
    "calculate_multimodality": lambda m, x: [m.calculate_multimodality(x["mm"], k, seed=2) for k in (3, 10)],
    "calculate_activation_statistics": lambda m, x: np.concatenate(
        [a.ravel() for a in m.calculate_activation_statistics(x["motion"])]),
    "fid_from_activations": lambda m, x: m.fid_from_activations(x["motion"], x["text"]),
    "get_metric_statistics": lambda m, x: np.concatenate(m.get_metric_statistics(x["reps"], 20)),
    "evaluate_replications": lambda m, x: np.concatenate(
        [np.r_[v] for _k, v in sorted(m.evaluate_replications(lambda r: {"a": float(r) ** 2, "b": x["reps"][r]},
                                                              4).items())]),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_jax(name):
    x = metric_inputs()
    got, ref = np.asarray(METRICS[name](P, x), np.float64), np.asarray(METRICS[name](J, x), np.float64)
    assert got.shape == ref.shape
    assert rel_err(got, ref) <= METRIC_REL, (name, got, ref)


def test_r_precision_counts_hits():
    x = metric_inputs()
    matching, r = P.matching_and_r_precision(x["text"], x["text"])
    assert matching < 1e-3 and list(r) == [1.0, 1.0, 1.0]  # f32 |a|² - 2a·b + |b|² cancels to ~1e-4
    _, r = P.matching_and_r_precision(x["text"], x["motion"])
    assert 4 / 12 <= r[0] <= r[1] <= r[2] <= 1.0


# ---------------------------------------------------------------------------
# the oracle on the committed artifact
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def oracles():
    """JAX's oracle on the artifact's tree (what ``from_artifact`` loads,
    without its eager template init) and the port's ``from_artifact``."""
    meta = json.loads(Path(J.T2MEvaluator.DEFAULT_ARTIFACT).with_suffix(".json").read_text())
    tree = jax.tree.map(jnp.asarray, P.load_oracle_params(J.T2MEvaluator.DEFAULT_ARTIFACT))
    return J.T2MEvaluator(J.T2MEvalConfig(**meta["config"]), params=tree), P.T2MEvaluator.from_artifact(device="cpu")


def motion_batch(dim_pose=623, frames=40):
    g = np.random.default_rng(1)
    # lengths: whole, m_lens // 4 == 0, not a multiple of 4, short, long
    lens = np.array([frames, 3, 17, 8, 30])
    return g.normal(size=(5, frames, dim_pose)).astype(np.float32), np.minimum(lens, frames)


def text_batch(dim_word=300, dim_pos=15, length=12):
    g = np.random.default_rng(2)
    pos = np.eye(dim_pos, dtype=np.float32)[g.integers(0, dim_pos, (4, length))]
    return g.normal(size=(4, length, dim_word)).astype(np.float32), pos, np.array([length, 1, 5, 9])


def test_oracle_motion_tower_matches_jax(oracles):
    jev, pev = oracles
    motion, m_lens = motion_batch()
    ref = jev.get_motion_embeddings(motion, m_lens)
    got = pev.get_motion_embeddings(motion, m_lens)
    assert got.shape == ref.shape == (5, 256)
    assert rel_err(got, ref) <= TOWER_REL
    # frames beyond a row's valid movement steps and their receptive field are not read (m_lens 3: one step,
    # which two stride-2 convolutions of width 4 compute from frames 0-6)
    padded = motion.copy()
    padded[1, 7:] = 100.0
    np.testing.assert_array_equal(pev.get_motion_embeddings(padded, m_lens)[1], got[1])


def test_oracle_text_tower_matches_jax(oracles):
    jev, pev = oracles
    we, pos, lens = text_batch()
    motion, m_lens = motion_batch()
    t_ref, m_ref = jev.get_co_embeddings(we, pos, lens, motion[:2], m_lens[:2])
    t_got, m_got = pev.get_co_embeddings(we, pos, lens, motion[:2], m_lens[:2])
    assert t_got.shape == t_ref.shape == (4, 256)
    assert rel_err(t_got, t_ref) <= TOWER_REL and rel_err(m_got, m_ref) <= TOWER_REL


def test_from_artifact_default_and_missing(oracles, tmp_path):
    jev, pev = oracles
    assert pev.cfg == P.T2MEvalConfig(hidden=512, dim_movement=256, dim_coemb=256, dim_pose=623)
    assert P.T2MEvaluator.DEFAULT_ARTIFACT == J.T2MEvaluator.DEFAULT_ARTIFACT
    # the bridge's reverse direction gives back the artifact's tree, leaf for leaf
    tree = bridge.t2m_oracle_to_flax(pev)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                            jax.tree.leaves(jax.tree.map(np.asarray, jev.params))):
        np.testing.assert_array_equal(a, b.astype(np.float32), err_msg=jax.tree_util.keystr(path))
    with pytest.raises(FileNotFoundError, match="missing"):
        P.T2MEvaluator.from_artifact(str(tmp_path / "absent.npz"), device="cpu")


def test_seeded_oracle_is_deterministic():
    cfg = P.T2MEvalConfig(dim_pose=24, dim_word=12, dim_pos_ohot=5, dim_movement=16, dim_coemb=8, hidden=16)
    motion, m_lens = motion_batch(24, 16)
    a = P.T2MEvaluator(cfg, device="cpu").get_motion_embeddings(motion, m_lens)
    b = P.T2MEvaluator(cfg, device="cpu").get_motion_embeddings(motion, m_lens)
    c = P.T2MEvaluator(cfg, seed=1, device="cpu").get_motion_embeddings(motion, m_lens)
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and not np.allclose(a, c)


# ---------------------------------------------------------------------------
# the oracle's train step
# ---------------------------------------------------------------------------

SMALL = dict(dim_pose=24, dim_word=12, dim_pos_ohot=5, dim_movement=16, dim_coemb=8, hidden=16)


def test_oracle_train_step_matches_jax():
    jcfg, pcfg = J.T2MEvalConfig(**SMALL), P.T2MEvalConfig(**SMALL)
    jev = J.T2MEvaluator(jcfg)
    jparams = perturbed(jev.params, 7)
    pev = P.T2MEvaluator(pcfg, params=jax.tree.map(np.asarray, jparams), device="cpu")
    batches = []
    for s in range(1):
        motion, m_lens = motion_batch(24, 16)
        motion = motion + s
        we, pos, lens = text_batch(12, 5, 6)
        m_lens, lens = m_lens[:4], np.array([6, 2, 1, 4])
        jb = {"motion": jnp.asarray(motion[:4]), "m_lens": jnp.asarray(m_lens), "word_embs": jnp.asarray(we + s),
              "pos_ohot": jnp.asarray(pos), "cap_lens": jnp.asarray(lens)}
        batches.append((jb, {k: torch.as_tensor(np.asarray(v)) for k, v in jb.items()}))
    run_steps(lambda tx: J.make_t2m_oracle_train_step(jev.motion_enc, jev.text_enc, tx),
              lambda tx: P.make_t2m_oracle_train_step(pev.motion_enc, pev.text_enc, tx), jparams,
              {"text": pev.text_enc, "motion": pev.motion_enc}, batches, "adam")
