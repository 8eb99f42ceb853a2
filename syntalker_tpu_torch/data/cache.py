"""Clip preprocessing, the windowed sample cache and the trainers' loaders.

Counterpart of ``syntalker_tpu/data/cache.py``, array for array:

- ``preprocess_clip`` turns one BEAT2 clip into aligned per-frame arrays
  (poses, root-zeroed translation and its velocity, betas, expressions,
  foot contacts and the 623-d h3d features when given an SMPL-X model,
  onset+amplitude audio, word ids, emotion, semantic scores);
- ``BeatCache`` keeps one compressed ``.npz`` per clip and a window index
  (``index.json``); windows are views computed at read time;
- ``BatchLoader`` assembles shuffled host batches, ``PrefetchLoader`` does
  so on a thread;
- ``DeviceDataset`` stacks every window once into tensors on the trainer's
  device and hands out index vectors; a step gathers its batch there with
  ``index_select``, so the only host-to-device copy a step makes is the
  index vector.

The shuffles of ``BatchLoader.epoch`` and ``DeviceDataset.epoch_indices`` are
``np.random.default_rng(seed + epoch)``, as in JAX's package, so the two
packages see the same batches in the same order.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from syntalker_tpu_torch.data import audio as A
from syntalker_tpu_torch.data.h3d import h3d_features_from_pose
from syntalker_tpu_torch.data.textgrid import words_tier
from syntalker_tpu_torch.data.vocab import Vocab, words_to_frame_ids
from syntalker_tpu_torch.device import full_f32, resolve_device
from syntalker_tpu_torch.ops.smplx import foot_contacts
from syntalker_tpu_torch.parallel.collectives import exact_sum


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    pose_fps: int = 30
    audio_sr: int = 16000
    pose_length: int = 128  # frames per training window
    stride: int = 20  # training window stride
    clean_first_seconds: int = 0
    clean_final_seconds: int = 0
    facial_dims: int = 100


def emotion_label(clip_id: str) -> int:
    """Emotion score from the BEAT recording-id ranges
    (beat_sep_lower.py:552-575)."""
    try:
        start = int(clip_id.split("_")[3])
    except (IndexError, ValueError):
        return 0
    ranges = [
        (1, 64, 0), (65, 72, 1), (73, 80, 2), (81, 86, 3),
        (87, 94, 4), (95, 102, 5), (103, 110, 6), (111, 118, 7),
    ]
    for lo, hi, score in ranges:
        if lo <= start <= hi:
            return score
    return 0


def parse_sem_scores(
    sem_path: str | Path,
    n_frames: int,
    pose_fps: int = 30,
    time_offset: float = 0.0,
) -> np.ndarray:
    """Per-frame semantic relevance from a BEAT sem .txt
    (tab-separated: name, start_time, end_time, duration, score, keywords;
    beat_sep_lower.py:579-596). Frames outside any span score 0.

    Vectorized over spans instead of the reference's per-frame linear scan;
    the reference takes the FIRST matching span, so overlapping spans are
    resolved by earliest-row-wins here too."""
    spans = []
    with open(sem_path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 5:
                continue
            try:
                spans.append((float(parts[1]), float(parts[2]), float(parts[4])))
            except ValueError:
                continue
    scores = np.zeros(n_frames, np.float32)
    if not spans:
        return scores
    t = np.arange(n_frames, dtype=np.float64) / pose_fps + time_offset
    assigned = np.zeros(n_frames, bool)
    for start, end, score in spans:  # first match wins
        hit = (t >= start) & (t <= end) & ~assigned
        scores[hit] = score
        assigned |= hit
    return scores


def trans_velocity(trans: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Root-zeroed translation + per-frame x/z velocity with y passthrough
    (beat_sep_lower.py:258-267)."""
    t = trans.astype(np.float32).copy()
    t[:, 0] -= t[0, 0]
    t[:, 2] -= t[0, 2]
    v = np.zeros_like(t)
    v[1:, 0] = t[1:, 0] - t[:-1, 0]
    v[1:, 2] = t[1:, 2] - t[:-1, 2]
    if len(t) > 1:
        v[0, 0] = v[1, 0]
        v[0, 2] = v[1, 2]
    v[:, 1] = t[:, 1]
    return t, v


def preprocess_clip(
    pose_npz: str | Path,
    wav_path: Optional[str | Path],
    textgrid_path: Optional[str | Path],
    vocab: Optional[Vocab],
    cfg: ClipConfig = ClipConfig(),
    smplx_model=None,
    sem_path: Optional[str | Path] = None,
) -> Dict[str, np.ndarray]:
    """One BEAT2 clip -> aligned per-frame arrays (cache_generation
    semantics, beat_sep_lower.py:224-617). With an SMPL-X model
    (:mod:`~syntalker_tpu_torch.ops.smplx`, on its device, in full f32) the
    foot contacts come from its FK and the 623-d ``h3d`` array is made;
    without one the contacts are zeros and there is no ``h3d``, as in JAX's
    package."""
    data = np.load(pose_npz, allow_pickle=True)
    poses = np.asarray(data["poses"], np.float32)  # (N, 165)
    n = poses.shape[0]
    trans, trans_v = trans_velocity(np.asarray(data["trans"], np.float32))
    betas = np.asarray(data["betas"], np.float32).reshape(-1)[:300]
    facial = np.asarray(data["expressions"], np.float32)[:, : cfg.facial_dims]

    contacts = np.zeros((n, 4), np.float32)
    h3d = None
    if smplx_model is not None:
        dev = smplx_model.device
        pose_t, trans_t, betas_t = (torch.as_tensor(a, device=dev) for a in (poses, trans, betas))
        with full_f32():
            contacts_t = foot_contacts(smplx_model, pose_t, betas_t[None].expand(n, -1), trans_t,
                                       torch.as_tensor(facial, device=dev) if facial.shape[1] == 100 else None)
            # the 623-d HumanML3D representation of the text-control (h3d) stack
            h3d = h3d_features_from_pose(pose_t, betas_t, trans_t, smplx_model, contacts_t).cpu().numpy()
        contacts = contacts_t.cpu().numpy()

    out: Dict[str, np.ndarray] = {
        "poses": poses,
        "trans": trans,
        "trans_v": trans_v,
        "betas": betas,
        "facial": facial,
        "contacts": contacts.astype(np.float32),
    }
    if h3d is not None:
        out["h3d"] = h3d.astype(np.float32)

    if wav_path is not None:
        y, sr = A.load_wav_mono(wav_path, cfg.audio_sr)
        out["audio"] = A.onset_amplitude_features(y, sr)  # (S, 2)

    if textgrid_path is not None and vocab is not None:
        out["word"] = words_to_frame_ids(
            words_tier(textgrid_path), n, vocab, cfg.pose_fps
        )
    else:
        out["word"] = np.zeros(n, np.int32)
    out["emo"] = np.full(n, emotion_label(Path(pose_npz).stem), np.int32)
    out["sem"] = (
        parse_sem_scores(sem_path, n, cfg.pose_fps)
        if sem_path is not None and Path(sem_path).exists()
        else np.zeros(n, np.float32)
    )
    return out


@dataclasses.dataclass(frozen=True)
class WindowIndex:
    clip: str
    start: int  # pose-frame start
    length: int  # pose frames
    audio_start: int  # audio samples
    audio_length: int


def plan_clip_windows(
    n_frames: int,
    n_audio: int,
    clip: str,
    cfg: ClipConfig,
    *,
    is_test: bool,
) -> List[WindowIndex]:
    """Training/test windowing arithmetic (_sample_from_clip,
    beat_sep_lower.py:636-700): clip to whole seconds common to pose+audio,
    training windows of pose_length every stride, test = one whole-clip
    window."""
    fps, sr = cfg.pose_fps, cfg.audio_sr
    seconds = n_frames // fps
    if n_audio > 0:
        seconds = min(seconds, n_audio // sr)
    s_t = cfg.clean_first_seconds
    e_t = seconds - cfg.clean_final_seconds
    s_f, e_f = s_t * fps, e_t * fps

    if is_test:
        cut = e_f - s_f
        stride = cut
    else:
        cut = cfg.pose_length
        stride = cfg.stride
    if e_f - s_f < cut:
        return []
    num = (e_f - s_f - cut) // stride + 1
    audio_len = math.floor(cut / fps * sr)
    out = []
    for i in range(num):
        start = s_f + i * stride
        a_start = s_t * sr + math.floor(i * stride * sr / fps)
        out.append(WindowIndex(clip, start, cut, a_start, audio_len))
    return out


class BeatCache:
    """Directory of per-clip npz files + a window index.

    build: preprocess_clip each source clip once; windows are computed from
    the index at read time (zero duplication).
    """

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.clips: Dict[str, Dict[str, np.ndarray]] = {}
        self.windows: List[WindowIndex] = []

    # ---- building ----

    def add_clip(self, clip_id: str, arrays: Dict[str, np.ndarray], cfg: ClipConfig, *, is_test: bool):
        self.root.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(self.root / f"{clip_id}.npz", **arrays)
        self.clips[clip_id] = arrays
        n_audio = arrays["audio"].shape[0] if "audio" in arrays else 0
        self.windows.extend(
            plan_clip_windows(
                arrays["poses"].shape[0], n_audio, clip_id, cfg, is_test=is_test
            )
        )

    def save_index(self):
        idx = [dataclasses.asdict(w) for w in self.windows]
        (self.root / "index.json").write_text(json.dumps(idx))

    # ---- loading ----

    @classmethod
    def open(cls, root: str | Path) -> "BeatCache":
        self = cls(root)
        idx = json.loads((self.root / "index.json").read_text())
        self.windows = [WindowIndex(**w) for w in idx]
        for clip in sorted({w.clip for w in self.windows}):
            with np.load(self.root / f"{clip}.npz") as z:
                self.clips[clip] = {k: z[k] for k in z.files}
        return self

    def __len__(self):
        return len(self.windows)

    def get(self, i: int) -> Dict[str, np.ndarray]:
        """One sample dict matching the reference __getitem__
        (beat_sep_lower.py:757-783): pose is the 165-dof axis angle concat
        contacts (169), plus audio/word/facial/beta/trans/trans_v/emo."""
        w = self.windows[i]
        c = self.clips[w.clip]
        sl = slice(w.start, w.start + w.length)
        pose = np.concatenate([c["poses"][sl], c["contacts"][sl]], axis=1)
        betas = np.tile(c["betas"], (w.length, 1))
        sample = {
            "pose": pose.astype(np.float32),
            "trans": c["trans"][sl],
            "trans_v": c["trans_v"][sl],
            "facial": c["facial"][sl],
            "beta": betas.astype(np.float32),
            "word": c["word"][sl].astype(np.int32),
            "emo": c["emo"][sl],
            # per-frame semantic relevance (SRGR weighting); zeros for caches
            # built before the sem channel existed
            "sem": (
                c["sem"][sl].astype(np.float32)
                if "sem" in c
                else np.zeros(w.length, np.float32)
            ),
            "id": np.zeros(w.length, np.int32),
        }
        if "h3d" in c:
            sample["h3d"] = c["h3d"][sl].astype(np.float32)
        if "audio" in c:
            sample["audio"] = c["audio"][
                w.audio_start : w.audio_start + w.audio_length
            ].astype(np.float32)
        return sample


class PrefetchLoader:
    """Background-thread prefetch over any loader with .epoch(e): host batch
    assembly overlaps device compute (the role of torch DataLoader workers,
    train.py:54-61)."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def epoch(self, epoch: int):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        _END = object()

        def producer():
            for batch in self.loader.epoch(epoch):
                q.put(batch)
            q.put(_END)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _END:
                break
            yield item
        t.join()


class DatasetTooLargeError(RuntimeError):
    """The window set exceeds the device memory budget."""


def default_memory_budget(device: torch.device) -> int:
    """40% of the card's memory, or 6 GiB for the CPU."""
    if device.type == "cuda":
        return int(0.4 * torch.cuda.mem_get_info(device)[1])
    return 6 * 2**30


class DeviceDataset:
    """Every window of a cache resident on one device (CUDA unless
    ``device="cpu"``); batches are gathered there by index instead of
    copied from the host each step.

    The windows are stacked once on the host (one sample at a time into
    preallocated arrays, so the corpus is never held twice) and copied to
    ``device``. ``placement`` is decided from the set's bytes against a
    device's ``memory_budget_bytes`` (default :func:`default_memory_budget`),
    in JAX's three tiers:

    1. ``"replicated"``: the set fits one device; the whole set is on it
       (on every rank's device under a process group).
    2. ``"data_sharded"``: it does not, but a 1/``data`` slice of it fits,
       and ``mesh`` is a process-group mesh with ``data > 1``: each rank of
       the data axis holds its contiguous slice of the windows (the set
       padded to a multiple of ``data`` with copies of its first windows,
       which no index reaches). A batch's rows are gathered across the
       data axis by an all-reduce of zero-padded buffers, bit for bit.
    3. Otherwise the constructor raises :class:`DatasetTooLargeError` and
       the trainers stream host batches instead.

    ``epoch_indices`` gives the int32 index vectors of an epoch, the same as
    ``BatchLoader``'s batches (same permutation, drop-last); ``batch(idx)``
    copies one of them to the device and gathers the batch there: the
    global batch, on every rank of a mesh, whatever the placement."""

    def __init__(self, cache: BeatCache, keys, batch_size: int, *, seed=0, shuffle=True, device=None,
                 memory_budget_bytes=None, mesh=None):
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.device = resolve_device(device)
        self.n = len(cache)
        if self.n == 0:
            raise ValueError("DeviceDataset: the cache holds no windows (len(cache)==0); "
                             "check the split/speaker filters used to build it")
        first = cache.get(0)
        keys = [k for k in keys if k in first]
        host = {k: np.empty((self.n,) + np.shape(first[k]), dtype=np.asarray(first[k]).dtype) for k in keys}
        for k in keys:
            host[k][0] = first[k]
        for i in range(1, self.n):
            s = cache.get(i)
            for k in keys:
                host[k][i] = s[k]
        self.nbytes = sum(v.nbytes for v in host.values())
        if memory_budget_bytes is None:
            memory_budget_bytes = default_memory_budget(self.device)
        self.memory_budget_bytes = memory_budget_bytes
        n_data = mesh.shape["data"] if mesh is not None and mesh.in_group else 1
        self._axis = None
        if self.nbytes <= memory_budget_bytes:
            self.placement = "replicated"
            self.arrays = {k: torch.from_numpy(host.pop(k)).to(self.device) for k in keys}
        elif n_data > 1 and self.nbytes / n_data <= memory_budget_bytes:
            self.placement = "data_sharded"
            self._axis = mesh.data
            pad = (-self.n) % n_data
            self.shard_rows = (self.n + pad) // n_data
            lo = self._axis.index * self.shard_rows
            self.arrays = {}
            for k in keys:
                v = host.pop(k)
                if pad:
                    v = np.concatenate([v, v[:pad]], axis=0)
                self.arrays[k] = torch.from_numpy(np.ascontiguousarray(v[lo : lo + self.shard_rows])).to(self.device)
        else:
            raise DatasetTooLargeError(
                f"window cache is {self.nbytes / 2**30:.2f} GiB ({self.nbytes / n_data / 2**30:.2f} GiB a device "
                f"sharded over data={n_data}) vs a {memory_budget_bytes / 2**30:.2f} GiB budget on {self.device}; "
                "stream from the host instead (train.device_data=false)")

    def __len__(self):
        return self.n // self.batch_size

    def epoch_indices(self, epoch: int):
        """Per-batch int32 index vectors; the order of ``BatchLoader``."""
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        for b in range(len(self)):
            yield order[b * self.batch_size : (b + 1) * self.batch_size].astype(np.int32)

    def batch(self, idx: np.ndarray) -> Dict[str, torch.Tensor]:
        """The batch of one index vector, gathered on the device. Sharded,
        every rank of the data axis must ask for the same vector: each
        writes the rows it holds into a zero batch, and the batches are
        summed over the axis."""
        idx = np.asarray(idx, np.int64)
        if self.placement == "replicated":
            i = torch.from_numpy(idx).to(self.device)
            return {k: v.index_select(0, i) for k, v in self.arrays.items()}
        owner, row = np.divmod(idx, self.shard_rows)
        mine = owner == self._axis.index
        at = torch.from_numpy(np.nonzero(mine)[0]).to(self.device)
        src = torch.from_numpy(row[mine]).to(self.device)
        out = {}
        for k, v in self.arrays.items():
            buf = v.new_zeros((len(idx),) + tuple(v.shape[1:]))
            buf[at] = v.index_select(0, src)
            out[k] = exact_sum(buf, self._axis)
        return out


class BatchLoader:
    """Deterministic shuffled batcher over a BeatCache: numpy batches of
    ``batch_size`` windows, drop-last by default."""

    def __init__(self, cache: BeatCache, batch_size: int, *, shuffle=True, seed=0, drop_last=True):
        self.cache = cache
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.cache)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int):
        order = np.arange(len(self.cache))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        for b in range(len(self)):
            idx = order[b * self.batch_size : (b + 1) * self.batch_size]
            samples = [self.cache.get(int(i)) for i in idx]
            yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}
