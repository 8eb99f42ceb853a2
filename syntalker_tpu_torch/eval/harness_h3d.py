"""Text-controlled (h3d) evaluation: prompted generation and the HumanML3D suite.

Counterpart of ``syntalker_tpu/eval/harness_h3d.py`` (the reference's
``test_h3d.py`` + ``h3d_diffusion_new_trainer.py``: _g_test :465-607, test
:818-905, eval :907-1060): each clip is generated on the 623-d
representation, seeded with the ground truth's continuous RVQ latents
(``map2latent``, no snap), optionally steered by per-body-part text
prompts through the body-part CFG (``generation.sample_windows`` with
``prompts=``: every step's guidance branches in one K2 call on the card),
decoded by ``generation.decode_latents_h3d`` (K3 once a part), and scored
with the BiGRU co-embedding oracle: R-precision, Matching, FID, Diversity
and MultiModality over N replications (mean ± 95% CI), and the steering
metrics (prompted against unprompted from the same noise).

JAX's threefry chain has no PyTorch counterpart. Each generation draws its
initial noise (and DDPM's step noise) from its own ``torch.Generator``,
seeded from a key path that follows JAX's ``fold_in`` structure: ``(seed,
replication, clip)`` in :meth:`H3DEvaluator.evaluate`, ``(seed,
replication, clip, 1000 + r)`` for MultiModality's repeats and ``(seed,
10000 + clip)`` in :meth:`H3DEvaluator.steering_metrics`. A ``noise`` hook
``(path, plan) -> ClipNoise`` (the path without the seed) replaces them, so
that a test can feed JAX's draws.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from syntalker_tpu_torch import generation as G
from syntalker_tpu_torch.data import joints as J
from syntalker_tpu_torch.data.cache import BeatCache
from syntalker_tpu_torch.data.h3d import part_mask_623
from syntalker_tpu_torch.device import resolve_device
from syntalker_tpu_torch.eval import t2m
from syntalker_tpu_torch.models.tmr import TextPipeline
from syntalker_tpu_torch.ops.mdm_cuda import make_fused_denoise, stack_block_weights

log = logging.getLogger("syntalker")

# a generation's draws: initial noise (W, 1, T, 1536), and DDPM's step noise (w, it) -> (1, T, 1536) or None
ClipNoise = Tuple[torch.Tensor, Optional[Callable[[int, int], torch.Tensor]]]
NoiseHook = Callable[[tuple, G.WindowPlan], ClipNoise]


def key_seed(path: Sequence[int]) -> int:
    """The generator seed of a key path (``(seed, replication, clip)``...)."""
    return int(np.random.SeedSequence(tuple(int(k) for k in path)).generate_state(1)[0])


def _path(seed) -> tuple:
    return tuple(seed) if isinstance(seed, (tuple, list)) else (int(seed),)


class H3DEvaluator:
    """``mdm`` (a ``use_prompt`` MDM of the port), ``diffusion``,
    ``rvq_modules`` (part -> (RVQVAE, RVQState) of the h3d623 parts),
    ``h3d_stats``; ``text_pipeline`` embeds the prompts (default: the
    seeded ``TextPipeline``), ``t2m_evaluator`` scores. ``denoise(x_t,
    t_emb, cond) -> x0`` defaults to K2 with bf16 weights, built once.
    Sampling is DDIM when the schedule has fewer than 1,000 steps, else
    DDPM. Runs on CUDA unless ``device="cpu"``."""

    def __init__(self, *, mdm, diffusion, rvq_modules: dict, h3d_stats, text_pipeline: Optional[TextPipeline] = None,
                 t2m_evaluator: Optional[t2m.T2MEvaluator] = None, pose_length: int = 128, pre_frames: int = 4,
                 latent_scale: float = 5.0, guidance: Optional[dict] = None, denoise=None, device=None):
        self.device = resolve_device(device)
        self.mdm = mdm
        self.diffusion = diffusion
        self.rvq_modules = rvq_modules
        self.h3d_stats = h3d_stats
        self.text_pipeline = text_pipeline or TextPipeline(device=self.device)
        self.t2m_evaluator = t2m_evaluator
        self.pose_length = pose_length
        self.pre_frames = pre_frames
        self.latent_scale = latent_scale
        self.guidance = guidance or {"audio_scale": 1.0, "prompt_scale": 4.0}
        self.sampler = "ddim" if diffusion.num_steps < 1000 else "ddpm"
        self.denoise = denoise if denoise is not None else make_fused_denoise(mdm, stack_block_weights(mdm))
        self._masks = {p: torch.as_tensor(part_mask_623(p), device=self.device).long() for p in J.LATENT_SLICES}

    def plan(self, sample: Dict[str, np.ndarray]) -> G.WindowPlan:
        return G.plan_windows(sample["pose"].shape[0], pose_length=self.pose_length, pre_frames=self.pre_frames)

    def clip_noise(self, path: Sequence[int], plan: G.WindowPlan) -> ClipNoise:
        """The draws of key path ``path`` from its own generator: every
        window's initial noise, then, for DDPM, each step's in (window,
        step) order."""
        gen = torch.Generator(self.device).manual_seed(key_seed(path))
        init = G.draw_noise(plan, 1, gen, self.device)
        if self.sampler != "ddpm":
            return init, None
        return init, lambda w, it: torch.randn(init.shape[1:], generator=gen, device=self.device)

    @torch.no_grad()
    def gt_latents(self, h3d: np.ndarray) -> torch.Tensor:
        """A clip's ground-truth 623-d features (T, 623) -> the scaled
        continuous latents (1, T/4, 1536) of the RVQ-VAE encoders."""
        x = self.h3d_stats.normalize(torch.as_tensor(h3d[None], device=self.device))
        lat = [self.rvq_modules[p][0].map2latent(x[..., self._masks[p]]) for p in J.LATENT_SLICES]
        return torch.cat(lat, dim=-1) / self.latent_scale

    @torch.no_grad()
    def generate_clip(self, sample: Dict[str, np.ndarray], noise: ClipNoise,
                      prompts: Optional[Dict[str, Optional[str]]] = None) -> dict:
        """One clip -> its generated 623-d ``features`` and ``joints``
        (numpy), the ground truth's ``gt_features`` over the same frames and
        ``n_frames``; ``prompts`` maps body parts to text (empty or None:
        that part follows the audio)."""
        plan = self.plan(sample)
        dev = self.device
        aw = torch.as_tensor(G.window_audio(sample["audio"][None], plan), device=dev)
        ww = torch.as_tensor(G.window_words(sample["word"][None], plan), device=dev).long()
        init_seed = self.gt_latents(sample["h3d"])[:, : plan.pre_frames]
        prompt_embs = None
        if prompts and any(prompts.values()):
            prompt_embs = {part: None if not text else self.text_pipeline.embed([text]).to(dev)
                           for part, text in prompts.items()}
        latents = G.sample_windows(self.mdm, self.diffusion, plan, aw, ww, init_seed, noise[0].to(dev),
                                   sampler=self.sampler, step_noise=noise[1], prompts=prompt_embs,
                                   guidance=self.guidance, denoise=self.denoise)
        dec = G.decode_latents_h3d(latents, rvq_modules=self.rvq_modules, h3d_stats=self.h3d_stats,
                                   latent_scale=self.latent_scale)
        n = dec["features"].shape[1]
        return {"features": dec["features"][0].cpu().numpy(), "joints": dec["joints"][0].cpu().numpy(),
                "gt_features": np.asarray(sample["h3d"][:n], np.float32), "n_frames": n}

    def _draws(self, seed, path: tuple, plan: G.WindowPlan, noise: Optional[NoiseHook]) -> ClipNoise:
        return noise(path, plan) if noise is not None else self.clip_noise(_path(seed) + path, plan)

    # ------------------------------------------------------------------

    def steering_metrics(self, cache: BeatCache, seed=0, *, captions: List[str], text_features: List[dict],
                         max_clips: int = 4, part: str = "upper", noise: Optional[NoiseHook] = None) -> dict:
        """For each clip, the generation unprompted and prompted with the
        clip's own caption on ``part``, from the same noise:

        - ``steering_prompt_gain``: the mean decrease of the oracle's
          text-motion distance when the prompt is applied (positive: the
          prompt pulls the motion toward the text);
        - ``steering_prompted_part_rel_change``: the prompted part's mean
          relative change in the 623-d features;
        - ``steering_offpart_leakage``: the same on the other parts (body-part
          CFG should leave them)."""
        n_clips = min(len(cache), max_clips, len(captions))
        gains, leaks, moved = [], [], []
        other = [p for p in J.LATENT_SLICES if p != part]
        for i in range(n_clips):
            sample = cache.get(i)
            draws = self._draws(seed, (10_000 + i,), self.plan(sample), noise)
            base = self.generate_clip(sample, draws)
            prompted = self.generate_clip(sample, draws, prompts={part: captions[i]})
            n = min(base["n_frames"], prompted["n_frames"])
            tf = text_features[i]
            t_emb, m_base = self.t2m_evaluator.get_co_embeddings(tf["word_embs"], tf["pos_ohot"], tf["cap_lens"],
                                                                 base["features"][None, :n], np.asarray([n]))
            _, m_prom = self.t2m_evaluator.get_co_embeddings(tf["word_embs"], tf["pos_ohot"], tf["cap_lens"],
                                                             prompted["features"][None, :n], np.asarray([n]))
            gains.append(float(np.linalg.norm(t_emb - m_base)) - float(np.linalg.norm(t_emb - m_prom)))

            def rel_change(p: str) -> float:
                mask = part_mask_623(p)
                b, q = base["features"][:n][:, mask], prompted["features"][:n][:, mask]
                return np.abs(q - b).mean() / (np.abs(b).mean() + 1e-9)

            moved.append(float(rel_change(part)))
            leaks.append(float(np.mean([rel_change(o) for o in other])))
        return {"steering_prompt_gain": float(np.mean(gains)),
                "steering_prompted_part_rel_change": float(np.mean(moved)),
                "steering_offpart_leakage": float(np.mean(leaks)), "steering_clips": n_clips,
                "steering_part": part}

    def evaluate(self, cache: BeatCache, seed=0, *, text_features: Optional[List[dict]] = None,
                 replications: int = 20, max_clips: Optional[int] = None, diversity_times: int = 300,
                 mm_repeats: int = 0, noise: Optional[NoiseHook] = None) -> Dict[str, tuple]:
        """The HumanML3D protocol: in each replication every clip (the first
        ``max_clips``) is generated and embedded by the oracle, and FID,
        Diversity and, with ``text_features`` (clip i's ``word_embs``,
        ``pos_ohot``, ``cap_lens``), Matching and R-precision@1-3 are
        scored; with ``mm_repeats`` > 1, MultiModality over that many
        generations of each clip. Returns metric -> (mean, 95% CI)."""
        assert self.t2m_evaluator is not None, "needs a T2MEvaluator oracle"
        oracle = self.t2m_evaluator
        n_clips = min(len(cache), max_clips or len(cache))

        def run_once(rep: int) -> Dict[str, float]:
            gen_embs, gt_embs, t_embs, mm_embs = [], [], [], []
            for i in range(n_clips):
                sample = cache.get(i)
                plan = self.plan(sample)
                out = self.generate_clip(sample, self._draws(seed, (rep, i), plan, noise))
                n = np.asarray([out["n_frames"]])
                ge = oracle.get_motion_embeddings(out["features"][None], n)
                gen_embs.append(ge)
                gt_embs.append(oracle.get_motion_embeddings(out["gt_features"][None], n))
                if text_features is not None:
                    tf = text_features[i]
                    t_embs.append(oracle.get_co_embeddings(tf["word_embs"], tf["pos_ohot"], tf["cap_lens"],
                                                           out["features"][None], n)[0])
                if mm_repeats > 1:
                    reps = [ge[0]]
                    for r in range(1, mm_repeats):
                        o2 = self.generate_clip(sample, self._draws(seed, (rep, i, 1000 + r), plan, noise))
                        reps.append(oracle.get_motion_embeddings(o2["features"][None],
                                                                 np.asarray([o2["n_frames"]]))[0])
                    mm_embs.append(np.stack(reps))
            gen, gt = np.concatenate(gen_embs), np.concatenate(gt_embs)
            metrics = {"fid": t2m.fid_from_activations(gen, gt),
                       "diversity": t2m.calculate_diversity(gen, min(diversity_times, len(gen) - 1), seed=rep)}
            if t_embs:
                matching, r = t2m.matching_and_r_precision(np.concatenate(t_embs), gen)
                metrics["matching"] = matching
                for k in range(len(r)):
                    metrics[f"r_precision_top{k + 1}"] = float(r[k])
            if mm_embs:
                metrics["multimodality"] = t2m.calculate_multimodality(np.stack(mm_embs), min(10, mm_repeats),
                                                                       seed=rep)
            log.info(f"replication {rep}: {metrics}")
            return metrics

        return t2m.evaluate_replications(run_once, replications)
