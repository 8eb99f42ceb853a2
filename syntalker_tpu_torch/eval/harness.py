"""BEAT2 test-split evaluation: generate each clip, score FGD, BeatAlign, L1Div and SRGR.

Counterpart of ``syntalker_tpu/eval/harness.py`` (the reference's
``test.py`` + ``CustomTrainer.test``): for every test clip, the windowed
sampler (``generation.sample_windows``: K2 a denoise step on the card)
seeded with the clip's ground-truth latents, the per-part decode
(``RVQVAE.latent2origin``: K3), the full-body rot6d with jaw and eyes
copied from the ground truth, then

- FGD between eval-VAE embeddings of generated and ground-truth motion,
- BeatAlign between the audio onsets and the generated upper-body beats,
- L1 diversity of the generated joints, SRGR where the cache has semantic
  scores, and the face-vertex L2 / velocity gaps (logged),

and ``res_``/``gt_`` npz pairs for rendering. Joints come from the port's
SMPL-X FK (:mod:`~syntalker_tpu_torch.ops.smplx`) when a body model is
given; without one only FGD is scored.

``batch_clips`` > 1 buckets the clips by window count and generates each
group as one batch. JAX's threefry chain has no PyTorch counterpart: each
clip draws its initial noise (and DDPM's step noise) from its own
``torch.Generator`` seeded from ``(seed, clip index)``, or takes its draws
from the ``noise`` hook of :meth:`GestureEvaluator.evaluate`. A batch
stacks the clips' own draws, so its rows are the sequential clips' rows.
``stage_seconds`` of the result splits the wall time between generation,
decode, FK/LBS, the FGD embedding, the host metrics and the npz writes
(the device synchronized at each boundary).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from syntalker_tpu_torch import generation as G
from syntalker_tpu_torch.data import joints as J
from syntalker_tpu_torch.data.cache import BeatCache
from syntalker_tpu_torch.data.features import pose_to_part_rot6d
from syntalker_tpu_torch.device import full_f32, resolve_device
from syntalker_tpu_torch.eval.metrics import SRGR, BeatAligner, L1Div, frechet_distance
from syntalker_tpu_torch.ops import smplx as S
from syntalker_tpu_torch.ops.mdm_cuda import make_fused_denoise, stack_block_weights
from syntalker_tpu_torch.train.diffusion_trainer import make_latent_encoder

log = logging.getLogger("syntalker")

STAGES = ("generate", "decode", "fk_lbs", "fgd_embed", "host_metrics", "write")
# a clip's draws: initial noise (W, 1, T, 1536), and DDPM's step noise (w, it) -> (1, T, 1536) or None
ClipNoise = Tuple[torch.Tensor, Optional[Callable[[int, int], torch.Tensor]]]
GT_FACE_IDX = np.concatenate([J.FACE_AA_IDX, np.arange(69, 75)])  # jaw, then both eyes


@dataclasses.dataclass
class EvalResult:
    fid: float
    bc: float
    l1div: float
    srgr: float  # nan when the cache has no semantic scores
    clips: int
    motion_seconds: float
    wall_seconds: float
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def clip_seed(seed: int, clip: int) -> int:
    """The generator seed of clip ``clip`` in a run seeded ``seed``."""
    return int(np.random.SeedSequence((seed, clip)).generate_state(1)[0])


def _pad_to(x: np.ndarray, length: int) -> np.ndarray:
    if x.shape[0] >= length:
        return x[:length]
    return np.pad(x, [(0, length - x.shape[0])] + [(0, 0)] * (x.ndim - 1))


class GestureEvaluator:
    """``mdm`` (the port's MDM), ``diffusion``, ``rvq_modules`` (part ->
    (RVQVAE, RVQState)), ``stats``; ``eval_vae`` (a ``VAESKConv``) for FGD,
    ``smplx_model`` for the joint metrics, ``mean_velocity`` (55,) for
    BeatAlign. ``denoise(x_t, t_emb, cond) -> x0`` defaults to K2 with bf16
    weights, built once. Runs on CUDA unless ``device="cpu"``."""

    def __init__(self, *, mdm, diffusion, rvq_modules: dict, stats, eval_vae=None, smplx_model=None,
                 mean_velocity: Optional[np.ndarray] = None, pose_length: int = 128, pre_frames: int = 4,
                 latent_scale: float = 5.0, sampler: str = "ddpm", align_mask: int = 60, vae_test_len: int = 32,
                 denoise=None, device=None):
        self.device = resolve_device(device)
        self.mdm = mdm
        self.diffusion = diffusion
        self.rvq_modules = rvq_modules
        self.stats = stats
        self.eval_vae = eval_vae
        self.smplx_model = smplx_model
        self.pose_length = pose_length
        self.pre_frames = pre_frames
        self.latent_scale = latent_scale
        self.sampler = sampler
        self.align_mask = align_mask  # edge frames excluded from BeatAlign (train.py:158)
        self.vae_test_len = vae_test_len
        self.aligner = BeatAligner(mean_velocity=mean_velocity) if mean_velocity is not None else None
        self.denoise = denoise if denoise is not None else make_fused_denoise(mdm, stack_block_weights(mdm))
        self._encode_latent = make_latent_encoder(rvq_modules, stats, latent_scale=latent_scale)
        self.stage_seconds = dict.fromkeys(STAGES, 0.0)

    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def _stage(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stage_seconds[name] += time.perf_counter() - t0

    def plan(self, sample: Dict[str, np.ndarray]) -> G.WindowPlan:
        return G.plan_windows(sample["pose"].shape[0], pose_length=self.pose_length, pre_frames=self.pre_frames)

    def clip_noise(self, seed: int, clip: int, plan: G.WindowPlan) -> ClipNoise:
        """Clip ``clip``'s draws from its own generator: the initial noise of
        every window first, then, for DDPM, each step's in (window, step)
        order."""
        gen = torch.Generator(self.device).manual_seed(clip_seed(seed, clip))
        init = G.draw_noise(plan, 1, gen, self.device)
        if self.sampler != "ddpm":
            return init, None
        return init, lambda w, it: torch.randn(init.shape[1:], generator=gen, device=self.device)

    def groups(self, samples: Dict[int, dict], batch_clips: int) -> list:
        """The generation batches, as lists of clip indices: one clip each
        for ``batch_clips`` <= 1, else the clips bucketed by window count
        (fewest windows first), at most ``batch_clips`` a batch."""
        if batch_clips <= 1:
            return [[i] for i in samples]
        buckets: Dict[int, list] = {}
        for i, s in samples.items():
            buckets.setdefault(self.plan(s).num_windows, []).append(i)
        return [idxs[lo : lo + batch_clips] for _w, idxs in sorted(buckets.items())
                for lo in range(0, len(idxs), batch_clips)]

    @staticmethod
    def _face_only_pose(aa: torch.Tensor) -> torch.Tensor:
        """All joints zero except jaw and eyes (the face-mesh comparison pose)."""
        out = torch.zeros_like(aa)
        out[..., 66:75] = aa[..., 66:75]
        return out

    def _fgd_embed(self, rot6d: np.ndarray) -> np.ndarray:
        n = rot6d.shape[1] - rot6d.shape[1] % self.vae_test_len
        x = torch.as_tensor(rot6d[:, :n], device=next(self.eval_vae.parameters()).device)
        with torch.no_grad():
            z = self.eval_vae.map2latent(x)
        return z.reshape(-1, z.shape[-1]).cpu().numpy()

    @torch.no_grad()
    def sample_latents(self, samples: list, noises: list, denoise=None):
        """Clips of one window count generated in one batch: (latents (B,
        T_lat, 1536), their plan, the ground-truth axis-angle (B, N, 165)).
        ``noises[i]`` is clip i's :data:`ClipNoise`; ``denoise`` replaces
        the evaluator's. Input buffers are cut to the group's shortest plan:
        every plan of a window count generates the same n = seed_span +
        W·round_l frames, and n is at most each clip's own trimmed length, so
        no window reads past the shortest buffer."""
        plans = [self.plan(s) for s in samples]
        assert len({p.num_windows for p in plans}) == 1, "bucket by window count"
        plan = min(plans, key=lambda p: p.n_frames)
        dev = self.device

        def stack(key, length):
            return np.stack([_pad_to(s[key], length) for s in samples])

        # a group of one encodes its whole clip for the seed, as JAX's evaluate_clip does
        frames = plan.n_frames if len(samples) > 1 else samples[0]["pose"].shape[0]
        aw = torch.as_tensor(G.window_audio(stack("audio", 533 * plan.n_frames), plan), device=dev)
        ww = torch.as_tensor(G.window_words(stack("word", plan.n_frames), plan), device=dev).long()
        pose_aa = torch.as_tensor(stack("pose", frames)[..., : J.AXIS_ANGLE_DIM], device=dev)
        parts = pose_to_part_rot6d(pose_aa)
        gt_latents = self._encode_latent(parts["upper"], parts["hands"], parts["lower"],
                                         torch.as_tensor(stack("trans_v", frames), device=dev))
        init = torch.cat([nz[0].to(dev) for nz in noises], dim=1)
        step_noise = None
        if self.sampler == "ddpm":
            def step_noise(w, it):
                return torch.cat([nz[1](w, it).to(dev) for nz in noises], dim=0)
        latents = G.sample_windows(self.mdm, self.diffusion, plan, aw, ww, gt_latents[:, : plan.pre_frames], init,
                                   sampler=self.sampler, step_noise=step_noise, denoise=denoise or self.denoise)
        return latents, plan, pose_aa

    @torch.no_grad()
    def evaluate_clips_batched(self, samples: list, noises: list) -> list:
        """Clips of one window count -> per-clip dicts (``n_frames``, rec/gt
        rot6d and axis-angle, ``rec_trans``, ``gt_trans``, ``betas``), all
        generated in one batch (:meth:`sample_latents`) and decoded."""
        with self._stage("generate"):
            latents, plan, pose_aa = self.sample_latents(samples, noises)
        n = plan.out_latent_frames * plan.squeeze
        with self._stage("decode"):
            dec = G.decode_latents(latents, rvq_modules=self.rvq_modules, stats=self.stats,
                                   latent_scale=self.latent_scale)
            # jaw + eyes copied from the ground truth (trainer :526)
            face = torch.as_tensor(GT_FACE_IDX, device=self.device)
            rec_aa = dec["axis_angle"].clone()
            gt_aa = pose_aa[:, :n]
            rec_aa[..., face] = gt_aa[..., face]
            rec_rot6d = pose_to_part_rot6d(rec_aa)["full"].cpu().numpy()
            gt_rot6d = pose_to_part_rot6d(gt_aa)["full"].cpu().numpy()
            rec_aa, gt_aa, rec_trans = rec_aa.cpu().numpy(), gt_aa.cpu().numpy(), dec["trans"].cpu().numpy()
        return [{"n_frames": n, "rec_rot6d": rec_rot6d[i : i + 1], "gt_rot6d": gt_rot6d[i : i + 1],
                 "rec_aa": rec_aa[i : i + 1], "gt_aa": gt_aa[i : i + 1], "rec_trans": rec_trans[i : i + 1],
                 "gt_trans": s["trans"][:n], "betas": s["beta"][0]} for i, s in enumerate(samples)]

    def evaluate_clip(self, sample: Dict[str, np.ndarray], noise: ClipNoise) -> dict:
        """One whole-clip test sample -> generated motion (a group of one)."""
        return self.evaluate_clips_batched([sample], [noise])[0]

    @torch.no_grad()
    def _joint_metrics(self, out: dict, sample: dict, acc: dict) -> None:
        """FK of the generated (and, with semantic scores, the ground-truth)
        clip, the face-only meshes, then L1Div, SRGR and BeatAlign."""
        model, n = self.smplx_model, out["n_frames"]
        dev = model.device
        betas = torch.as_tensor(out["betas"], device=dev)[None].expand(n, -1)
        rec_aa = torch.as_tensor(out["rec_aa"][0], device=dev)
        gt_aa = torch.as_tensor(out["gt_aa"][0], device=dev)
        sem = sample.get("sem")
        use_sem = sem is not None and bool(np.any(sem[:n] != 0))
        with self._stage("fk_lbs"), full_f32():
            joints = S.forward_joints(model, rec_aa, betas).reshape(n, -1).cpu().numpy()
            # expression+jaw-only meshes (trainer :640-675): the face is copied
            # from the ground truth, so this checks the decode stayed face-neutral
            exps = torch.as_tensor(sample["facial"][:n], device=dev)
            face_rec = S.lbs(model, self._face_only_pose(rec_aa), betas, expressions=exps)["vertices"]
            face_tar = S.lbs(model, self._face_only_pose(gt_aa), betas, expressions=exps)["vertices"]
            acc["face_l2"] += float(((face_rec - face_tar) ** 2).mean()) * n
            dv = (face_rec[1:] - face_rec[:-1]) - (face_tar[1:] - face_tar[:-1])
            acc["face_lvd"] += float(dv.abs().mean()) * n
            gt_joints = S.forward_joints(model, gt_aa, betas).reshape(n, -1).cpu().numpy() if use_sem else None
        with self._stage("host_metrics"):
            acc["l1"].update(joints.copy())
            if use_sem:
                acc["have_sem"] = True
                acc["srgr"].update(joints, gt_joints, np.asarray(sem[:n]))
            if self.aligner is not None and "audio" in sample:
                t_on = np.nonzero(sample["audio"][:, 1])[0] / 16000.0
                a_lo, a_hi = self.align_mask / 30.0, (n - self.align_mask) / 30.0
                t_on = t_on[(t_on >= a_lo) & (t_on <= a_hi)] - a_lo
                beats = self.aligner.motion_beats(joints, self.align_mask, n - self.align_mask)
                acc["align_sum"] += self.aligner.score(t_on, beats) * (n - 2 * self.align_mask)
                acc["align_frames"] += n - 2 * self.align_mask

    @staticmethod
    def _write_pair(d: Path, i: int, out: dict, sample: dict) -> None:
        n = out["n_frames"]
        for prefix, poses, trans in (("res", out["rec_aa"][0], out["rec_trans"][0]),
                                     ("gt", out["gt_aa"][0], out["gt_trans"])):
            np.savez(d / f"{prefix}_{i:03d}.npz", poses=poses, trans=trans, betas=out["betas"],
                     expressions=sample["facial"][:n], model="smplx2020", gender="neutral", mocap_frame_rate=30)

    def evaluate(self, cache: BeatCache, seed: int = 999, *, out_dir: Optional[str | Path] = None,
                 max_clips: Optional[int] = None, batch_clips: int = 1,
                 noise: Optional[Callable[[int, G.WindowPlan], ClipNoise]] = None) -> EvalResult:
        """Every test clip (the first ``max_clips``) generated and scored.
        ``noise(clip, plan)`` replaces each clip's own draws."""
        t0 = time.perf_counter()
        self.stage_seconds = dict.fromkeys(STAGES, 0.0)
        acc = {"l1": L1Div(), "srgr": SRGR(joints=55), "have_sem": False, "align_sum": 0.0, "align_frames": 0,
               "face_l2": 0.0, "face_lvd": 0.0}
        n_clips = min(len(cache), max_clips or len(cache))
        samples = {i: cache.get(i) for i in range(n_clips)}

        def draws(i: int, plan: G.WindowPlan) -> ClipNoise:
            return noise(i, plan) if noise is not None else self.clip_noise(seed, i, plan)

        groups = self.groups(samples, batch_clips)
        log.info(f"eval: {n_clips} clips -> {len(groups)} batches")
        pending: list = []
        for group in groups:
            plan = min((self.plan(samples[i]) for i in group), key=lambda p: p.n_frames)
            outs = self.evaluate_clips_batched([samples[i] for i in group], [draws(i, plan) for i in group])
            pending.extend((i, samples[i], o) for i, o in zip(group, outs))

        lat_rec, lat_gt, total_frames = [], [], 0
        for i, sample, out in pending:
            total_frames += out["n_frames"]
            log.info(f"clip {i}: generated {out['n_frames']} frames")
            if self.eval_vae is not None:
                with self._stage("fgd_embed"):
                    lat_rec.append(self._fgd_embed(out["rec_rot6d"]))
                    lat_gt.append(self._fgd_embed(out["gt_rot6d"]))
            if self.smplx_model is not None:
                self._joint_metrics(out, sample, acc)
            if out_dir:
                with self._stage("write"):
                    d = Path(out_dir)
                    d.mkdir(parents=True, exist_ok=True)
                    self._write_pair(d, i, out, sample)

        with self._stage("host_metrics"):
            fid = frechet_distance(np.concatenate(lat_rec), np.concatenate(lat_gt)) if lat_rec else float("nan")
        if total_frames and self.smplx_model is not None:
            log.info(f"face l2: {acc['face_l2'] / total_frames:.6f}, face lvd: {acc['face_lvd'] / total_frames:.6f}")
        l1 = acc["l1"]
        result = EvalResult(
            fid=fid,
            bc=acc["align_sum"] / acc["align_frames"] if acc["align_frames"] else float("nan"),
            l1div=l1.result() if l1.counter else float("nan"),
            srgr=acc["srgr"].result() if acc["have_sem"] else float("nan"),
            clips=n_clips,
            motion_seconds=total_frames / 30.0,
            wall_seconds=time.perf_counter() - t0,
            stage_seconds=dict(self.stage_seconds),
        )
        log.info(f"eval: {result}")
        return result
