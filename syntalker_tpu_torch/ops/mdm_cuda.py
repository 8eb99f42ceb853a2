"""K1 and K2: the MDM block stack and the whole-window DDIM loop
(hand-written CUDA kernels + their plain versions).

Counterparts in ``syntalker_tpu/ops/mdm_pallas.py``:

- ``block_stack`` ↔ ``fused_block_stack`` / ``_block_kernel`` (K2): the
  pre-LN transformer stack on (B, T, D), weights stacked on a leading layer
  axis by :func:`stack_block_weights`;
- ``make_fused_denoise`` ↔ ``make_fused_denoise``: one denoise call with the
  stack through K2 and the in/out projections in PyTorch, as the JAX
  function leaves them to XLA. It runs the model's whole
  ``prepare_sequence``: the prompt and style concats too, where the
  conditioning carries them (JAX's reads neither, so its unprompted callers
  pass a conditioning without them);
- ``FusedDDIMWindow`` ↔ ``make_fused_ddim_window`` / ``_ddim_window_kernel``
  (K1): every step of one window's η=0 DDIM loop, the in/out projections,
  RoPE and the update included; :func:`make_fused_ddim_window` with
  ``mesh=`` runs one a device on the batch's data shards.

The kernels are in ``csrc/mdm_block.cu`` (its header says what bounds them
and how they are laid out). Hopper blocks carry no state from one launch to
the next, so where the TPU kernel ran one sequential grid, a layer here is
seven launches (LayerNorm, the qkv GEMM, attention, the proj GEMM with the
residual add, LayerNorm, the fc1 GEMM with GELU, the fc2 GEMM with the
residual add) and a K1 step adds its projections and its prologue, which
also does the first layer's LayerNorm. The launches of one window (K1) or
one pass of the stack (K2) are recorded once per (B, T) into a CUDA graph
over static buffers and replayed for every call: the TPU kernel was one
launch a window, and a graph is the card's way to that. The graphs belong to
the weights they read: K1's to its :class:`FusedDDIMWindow`, K2's to the
:class:`StackedWeights` that :func:`stack_block_weights` returns. :func:`window_launches` and :func:`block_launches` give
the number of kernels a replay runs; ``launches`` counts them under the
kernel's name. The TPU-only knobs ``tile_samples``, ``attn_group``,
``_VMEM_LIMIT`` and the RoPE permutation matrix have no counterpart.

Each wrapper takes the plain version for CPU tensors and launches the
kernels for CUDA tensors. The plain versions round to the weights' dtype at
the kernels' rounding points (every matmul input; weights stored bf16),
keep LayerNorm, softmax, residual stream and DDIM state in f32, and accept
``weights_dtype=torch.float32`` weights, which turns every rounding off.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from syntalker_tpu_torch.device import full_f32
from syntalker_tpu_torch.models.denoiser import MDM, Conditioning, rope_angles
from syntalker_tpu_torch.ops import _build

launches = {"ddim_window": 0, "block_stack": 0}

EPI_STORE, EPI_BIAS_BF16, EPI_BIAS_GELU_BF16, EPI_BIAS_RESIDUAL, EPI_DDIM = range(5)
LN_EPS = 1e-6


def _w(linear, dtype):
    """nn.Linear weight (out, in) -> the kernels' (in, out) layout."""
    return linear.weight.detach().t().contiguous().to(dtype)


def _b(linear):
    return linear.bias.detach().float().contiguous()


class StackedWeights(dict):
    """The dict of :func:`stack_block_weights`, with K2's graphs over these
    tensors beside it: ``plans`` maps (device, B, T, heads) to a
    ``_StackPlan``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.plans = {}


def stack_block_weights(mdm: MDM, weights_dtype=torch.bfloat16) -> StackedWeights:
    """The MDM's blocks as one dict of layer-stacked tensors: matmul weights
    (L, in, out) in ``weights_dtype``, LayerNorm parameters and biases
    (L, n) f32. The qkv columns are [q | k | v], each head-major."""
    blocks = mdm.blocks

    def stack(fn):
        return torch.stack([fn(blk) for blk in blocks]).contiguous()

    return StackedWeights({
        "ln1_s": stack(lambda b: b.norm1.weight.detach().float()),
        "ln1_b": stack(lambda b: b.norm1.bias.detach().float()),
        "wqkv": stack(lambda b: _w(b.qkv, weights_dtype)),
        "wproj": stack(lambda b: _w(b.proj, weights_dtype)),
        "bproj": stack(lambda b: _b(b.proj)),
        "ln2_s": stack(lambda b: b.norm2.weight.detach().float()),
        "ln2_b": stack(lambda b: b.norm2.bias.detach().float()),
        "wfc1": stack(lambda b: _w(b.fc1, weights_dtype)),
        "bfc1": stack(lambda b: _b(b.fc1)),
        "wfc2": stack(lambda b: _w(b.fc2, weights_dtype)),
        "bfc2": stack(lambda b: _b(b.fc2)),
    })


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w with a rounded to w's dtype, products accumulated in f32."""
    return a.to(w.dtype).float() @ w.float()


def _layer_norm(x, scale, bias, eps=LN_EPS):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _block_plain(x, w, layer, num_heads):
    b, t, d = x.shape
    hd = d // num_heads
    h = _layer_norm(x, w["ln1_s"][layer], w["ln1_b"][layer])
    qkv = _mm(h, w["wqkv"][layer]).reshape(b, t, 3, num_heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, H, T, hd)
    probs = torch.softmax((q * hd**-0.5) @ k.transpose(-1, -2), dim=-1)
    attn = (probs @ v).transpose(1, 2).reshape(b, t, d)
    x = x + _mm(attn, w["wproj"][layer]) + w["bproj"][layer]
    h = _layer_norm(x, w["ln2_s"][layer], w["ln2_b"][layer])
    h = F.gelu(_mm(h, w["wfc1"][layer]) + w["bfc1"][layer])
    return x + _mm(h, w["wfc2"][layer]) + w["bfc2"][layer]


def block_stack_plain(x: torch.Tensor, w: dict, *, num_heads: int) -> torch.Tensor:
    x = x.float()
    with full_f32():
        for layer in range(w["wqkv"].shape[0]):
            x = _block_plain(x, w, layer, num_heads)
    return x


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def block_launches(num_layers: int) -> int:
    """Kernels one pass of the block stack launches: per layer LayerNorm,
    qkv, attention, proj, LayerNorm, fc1, fc2."""
    return 7 * num_layers


def window_launches(num_layers: int, steps: int) -> int:
    """Kernels one K1 window launches: the audio/word slab and the style
    rows once; per step input_process, the x slab, the prologue (which also
    does the first layer's LayerNorm), the block stack and the output
    projection with the DDIM update."""
    return 2 + steps * (4 + block_launches(num_layers) - 1)


def check_gemm(a, w, epi, *, bias=None, out_f=None, out_h=None):
    """Raises on what mdm_gemm does not take."""
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"gemm: A {tuple(a.shape)} against W {tuple(w.shape)}")
    if w.dtype != torch.bfloat16 or a.dtype != torch.bfloat16:
        raise ValueError(f"gemm: A {a.dtype} and W {w.dtype}; both operands are bf16")
    m, k = a.shape
    n = w.shape[1]
    if m < 1 or k % 8 or n % 8:
        raise ValueError(f"gemm: M={m} N={n} K={k}; TMA rows are multiples of 16 bytes, so N and K of 8")
    out = out_h if epi in (EPI_BIAS_BF16, EPI_BIAS_GELU_BF16) else out_f
    want = torch.bfloat16 if out is out_h else torch.float32
    if out is None or out.shape != (m, n) or out.dtype != want:
        raise ValueError(f"gemm: epilogue {epi} writes {want} ({m}, {n})")
    if out is out_f and out_h is not None and (out_h.shape != (m, n) or out_h.dtype != torch.bfloat16):
        raise ValueError(f"gemm: the bf16 copy of the output is ({m}, {n}) bf16")
    if out_h is not None and epi == EPI_STORE:
        raise ValueError("gemm: only the residual and DDIM epilogues write a bf16 copy")
    if bias is not None and (bias.shape != (n,) or bias.dtype != torch.float32):
        raise ValueError(f"gemm: bias is f32 ({n},)")
    for t in (a, w, bias, out_f, out_h):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16 or t.device != a.device):
            raise ValueError("gemm: operands are contiguous, 16-byte aligned and on one device")


def check_attention(qkv, out, b, t, d, num_heads):
    """Raises on what mdm_attention does not take."""
    if d % num_heads or (d // num_heads) % 4:
        raise ValueError(f"attention: head width {d}/{num_heads} is not a multiple of 4")
    if qkv.shape != (b * t, 3 * d) or qkv.dtype != torch.float32 or not qkv.is_contiguous():
        raise ValueError(f"attention: qkv is contiguous f32 ({b * t}, {3 * d})")
    if out.shape != (b * t, d) or out.dtype != torch.bfloat16 or not out.is_contiguous():
        raise ValueError(f"attention: out is contiguous bf16 ({b * t}, {d})")
    hd = d // num_heads
    if 4 * (t * (2 * hd + 4) + (t + 3) * (hd + t)) > 160 * 1024:  # K, V, and q and scores of all rows
        raise ValueError(f"attention: {t} tokens x {hd} do not fit in shared memory")


def _ptr(t):
    return None if t is None else t.data_ptr()


@functools.cache
def _library(device_index: int):
    """csrc/mdm_block.cu, built, loaded and initialised for the device."""
    lib = _build.library("mdm_block")
    with torch.cuda.device(device_index):
        _build.check(lib.mdm_init(device_index), "mdm_init")
    return lib


class _Launcher:
    """Launches the csrc/mdm_block.cu kernels on the current stream. Every
    launch adds one to ``launched``; with ``count`` it also adds one to
    ``launches[name]`` (off while a CUDA graph records, since a recorded
    launch runs only when the graph is replayed)."""

    def __init__(self, name: str, device: torch.device, count: bool = True):
        self.name, self.count, self.launched = name, count, 0
        index = device.index if device.index is not None else torch.cuda.current_device()
        self.lib = _library(index)
        self.stream = torch.cuda.current_stream(device).cuda_stream

    def _done(self, err, what):
        _build.check(err, what)
        self.launched += 1
        if self.count:
            launches[self.name] += 1

    def layernorm(self, x, scale, shift, out):
        rows, d = x.shape
        if d % 4 or d > 1024 or x.dtype != torch.float32 or out.dtype != torch.bfloat16 or out.shape != x.shape:
            raise ValueError(f"layernorm: f32 rows of at most 1024, a multiple of 4, to bf16; got {tuple(x.shape)}")
        self._done(self.lib.mdm_layernorm_bf16(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(), rows, d, LN_EPS,
            self.stream), "mdm_layernorm_bf16")

    def gemm(self, a, w, epi, *, bias=None, out_f=None, out_h=None, ca=0.0, cb=0.0):
        check_gemm(a, w, epi, bias=bias, out_f=out_f, out_h=out_h)
        (m, k), n = a.shape, w.shape[1]
        self._done(self.lib.mdm_gemm(
            a.data_ptr(), w.data_ptr(), m, n, k, epi, _ptr(bias), _ptr(out_f), _ptr(out_h),
            float(ca), float(cb), self.stream), "mdm_gemm")

    def attention(self, qkv, out, b, t, d, num_heads):
        check_attention(qkv, out, b, t, d, num_heads)
        self._done(self.lib.mdm_attention(
            qkv.data_ptr(), out.data_ptr(), b, t, d, num_heads, (d // num_heads) ** -0.5,
            self.stream), "mdm_attention")

    def prologue(self, style_p, xe_p, at_p, bias, cos_t, sin_t, act, ln, act_ln, b, t, d, rope_heads):
        """``act_ln`` receives LayerNorm(act) with ``ln=(scale, shift)`` as bf16."""
        if d > 1024 or act.shape != (b * t, d) or act_ln.shape != act.shape or act_ln.dtype != torch.bfloat16:
            raise ValueError(f"prologue: rows of at most 1024, f32 and bf16 ({b * t}, {d}) outputs")
        self._done(self.lib.mdm_prologue(
            style_p.data_ptr(), xe_p.data_ptr(), at_p.data_ptr(), bias.data_ptr(),
            cos_t.data_ptr(), sin_t.data_ptr(), act.data_ptr(), ln[0].data_ptr(), ln[1].data_ptr(),
            act_ln.data_ptr(), LN_EPS, b, t, d, rope_heads, self.stream), "mdm_prologue")

    def blocks(self, x, w, b, t, num_heads, bufs, x_h=None, first_ln_done=False):
        """The layer loop on the f32 activation x (B*T, D), in place. With
        ``first_ln_done`` the first layer's LayerNorm of x is in ``bufs[0]``
        already. The last layer also writes the result as bf16 into ``x_h``
        if given."""
        d = x.shape[-1]
        h, qkv, attn, ff = bufs
        layers = w["wqkv"].shape[0]
        for layer in range(layers):
            if layer or not first_ln_done:
                self.layernorm(x, w["ln1_s"][layer], w["ln1_b"][layer], h)
            self.gemm(h, w["wqkv"][layer], EPI_STORE, out_f=qkv)
            self.attention(qkv, attn, b, t, d, num_heads)
            self.gemm(attn, w["wproj"][layer], EPI_BIAS_RESIDUAL, bias=w["bproj"][layer], out_f=x)
            self.layernorm(x, w["ln2_s"][layer], w["ln2_b"][layer], h)
            self.gemm(h, w["wfc1"][layer], EPI_BIAS_GELU_BF16, bias=w["bfc1"][layer], out_h=ff)
            self.gemm(ff, w["wfc2"][layer], EPI_BIAS_RESIDUAL, bias=w["bfc2"][layer], out_f=x,
                      out_h=x_h if layer == layers - 1 else None)


def _block_buffers(rows, d, f, device):
    bf = torch.bfloat16
    return (
        torch.zeros(rows, d, dtype=bf, device=device),
        torch.zeros(rows, 3 * d, device=device),
        torch.zeros(rows, d, dtype=bf, device=device),
        torch.zeros(rows, f, dtype=bf, device=device),
    )


class _Replay:
    """One CUDA graph of a fixed launch sequence over static buffers.

    ``record(launcher)`` makes the launches; it may read and write only
    tensors allocated before this object is built, and must not allocate or
    synchronise. It runs once for real on a side stream (which also fills
    the card's caches and loads the kernels), then once under capture, in
    the thread-local capture mode: other threads (a service's caller that
    copies the next request to the card) may go on using CUDA meanwhile.
    ``replay()`` runs the graph on the current stream and counts its kernel
    nodes in ``launches[name]``."""

    def __init__(self, name: str, device: torch.device, record):
        self.name = name
        self.record = record  # its closure keeps the buffers the graph reads and writes alive
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            record(_Launcher(name, device))
        current.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # a capture stream of this card: torch's default one is made once per process, on whichever card was
        # current at the first capture, and a capture on it would record none of this card's launches
        with torch.cuda.graph(self.graph, stream=torch.cuda.Stream(device), capture_error_mode="thread_local"):
            recorder = _Launcher(name, device, count=False)  # built on the capture stream
            record(recorder)
        self.nodes = recorder.launched

    def replay(self):
        self.graph.replay()
        launches[self.name] += self.nodes


def _check_cuda(x, w):
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not isinstance(w, StackedWeights):
        raise TypeError("the CUDA kernels take the StackedWeights of stack_block_weights, which keeps their graphs")
    if w["wqkv"].dtype != torch.bfloat16 or w["wqkv"].device != x.device:
        raise ValueError("the CUDA kernels take bf16 weights on the input's device")


class _StackPlan:
    """K2 for one (B, T): the static activation and scratch buffers and the
    graph of the layer loop over them."""

    def __init__(self, w, b, t, num_heads, device):
        d, f = w["wqkv"].shape[1], w["wfc1"].shape[-1]
        self.x = torch.zeros(b * t, d, device=device)
        bufs = _block_buffers(b * t, d, f, device)
        self.graph = _Replay("block_stack", device, lambda L: L.blocks(self.x, w, b, t, num_heads, bufs))


def block_stack(x: torch.Tensor, w: dict, *, num_heads: int) -> torch.Tensor:
    """K2: (B, T, D) -> (B, T, D) through the stacked blocks. CPU tensors
    take the plain version; CUDA tensors replay the graph of the kernels'
    launches, recorded once per (device, B, T) and kept in ``w.plans``, on
    the tensor's device whichever card is current."""
    if x.device.type == "cpu":
        return block_stack_plain(x, w, num_heads=num_heads)
    _check_cuda(x, w)
    b, t, d = x.shape
    with torch.cuda.device(x.device):
        key = (x.device, b, t, num_heads)
        plan = w.plans.get(key)
        if plan is None:
            plan = w.plans[key] = _StackPlan(w, b, t, num_heads, x.device)
        plan.x.copy_(x.reshape(b * t, d))
        plan.graph.replay()
        return plan.x.clone().reshape(b, t, d)


def make_fused_denoise(mdm: MDM, weights: dict):
    """``denoise(x_t, t_emb, cond) -> x0`` with the block stack through K2;
    input/output projections, the prompt and style concats and RoPE as in
    :meth:`MDM.denoise`."""
    heads = mdm.cfg.num_heads

    def denoise(x_t, t_emb, cond: Conditioning):
        xseq = mdm.prepare_sequence(x_t, t_emb, cond)
        return mdm.output_process(block_stack(xseq, weights, num_heads=heads))

    return denoise


class FusedDDIMWindow:
    """K1: one window's whole η=0 DDIM loop.

    Built once per (model, schedule): stacked weights, RoPE tables, the
    per-step timestep embeddings and coefficients in ITERATION order
    (iteration it is step i = S-1-it). ``run(x_init, cond)`` maps initial
    noise (B, T, C) to the final state; CPU tensors take the plain version,
    CUDA tensors replay a CUDA graph of the window's kernel launches,
    recorded once per (device, B, T), on the tensors' card whichever is
    current. The audio/word slab ``at @ W2[2D:]``
    and the style rows ``(seed_emb + t_emb) @ W2[:D]`` of all steps are
    computed once per window (the same products every step, so exact).
    """

    def __init__(self, mdm: MDM, diffusion, *, weights_dtype=torch.bfloat16):
        cfg = self.cfg = mdm.cfg
        d = cfg.latent_dim
        self.blocks = stack_block_weights(mdm, weights_dtype)
        w2 = _w(mdm.input_process2, weights_dtype)
        self.w_in, self.b_in = _w(mdm.input_process, weights_dtype), _b(mdm.input_process)
        self.w2_style, self.w2_x, self.w2_at = (
            w2[:d].contiguous(), w2[d : 2 * d].contiguous(), w2[2 * d :].contiguous())
        self.b_in2 = _b(mdm.input_process2)
        self.w_out, self.b_out = _w(mdm.output_process, weights_dtype), _b(mdm.output_process)
        device = self.w_in.device
        tmap = torch.as_tensor(np.asarray(diffusion.timestep_map), dtype=torch.long, device=device)
        with torch.no_grad():
            self.t_embs = mdm.embed_timesteps(tmap).flip(0).float().contiguous()  # (S, D)
        a, b = diffusion.ddim_coefficients()
        self.coef_a, self.coef_b = a.tolist(), b.tolist()
        self._rope = {}
        self._plans = {}  # (device, B, T) -> _WindowPlan

    def rope_tables(self, t: int, device):
        """(cos, sin) tables (T, hd) f32 for one rope sub-head."""
        key = (t, str(device))
        if key not in self._rope:
            ang = rope_angles(t, self.cfg.latent_dim // self.cfg.rope_heads).to(device)
            self._rope[key] = (torch.cos(ang).contiguous(), torch.sin(ang).contiguous())
        return self._rope[key]

    def __call__(self, x_init: torch.Tensor, cond: Conditioning) -> torch.Tensor:
        if x_init.device.type == "cpu":
            return self.plain(x_init, cond)
        with torch.cuda.device(x_init.device):
            return self._kernel(x_init, cond)

    def _inputs(self, x_init, cond):
        b, t, _ = x_init.shape
        a_dim = self.w2_at.shape[0]
        at = cond.at_feat[:, :t, :a_dim].float().contiguous()
        style = (cond.seed_emb.float()[None] + self.t_embs[:, None]).contiguous()  # (S, B, D)
        return b, t, at, style

    def plain(self, x_init: torch.Tensor, cond: Conditioning) -> torch.Tensor:
        """The reference math of K1 in PyTorch, on any device."""
        b, t, at, style = self._inputs(x_init, cond)
        cfg = self.cfg
        d, hd = cfg.latent_dim, cfg.latent_dim // cfg.rope_heads
        cos_t, sin_t = self.rope_tables(t, x_init.device)
        with full_f32():
            at_p = _mm(at, self.w2_at)  # (B, T, D)
            style_p = _mm(style, self.w2_style)  # (S, B, D)
            x = x_init.float()
            for it in range(len(self.coef_a)):
                x_emb = (_mm(x, self.w_in) + self.b_in).to(self.w_in.dtype)
                h = style_p[it][:, None] + _mm(x_emb, self.w2_x) + at_p + self.b_in2
                hh = h.reshape(b, t, cfg.rope_heads, hd)
                rotated = torch.cat([-hh[..., hd // 2 :], hh[..., : hd // 2]], dim=-1)
                h = (hh * cos_t[:, None] + rotated * sin_t[:, None]).reshape(b, t, d)
                for layer in range(self.blocks["wqkv"].shape[0]):
                    h = _block_plain(h, self.blocks, layer, cfg.num_heads)
                x0 = _mm(h, self.w_out) + self.b_out
                x = self.coef_a[it] * x + self.coef_b[it] * x0
        return x

    def _kernel(self, x_init: torch.Tensor, cond: Conditioning) -> torch.Tensor:
        _check_cuda(x_init, self.blocks)
        b, t, at, style = self._inputs(x_init, cond)
        key = (x_init.device, b, t)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = _WindowPlan(self, b, t, at.shape[-1], x_init.device)
        # the call's inputs into the graph's static buffers; the bf16 copies
        # round where the plain version's matmuls round their inputs
        plan.x.copy_(x_init.reshape(plan.x.shape))
        plan.x_h.copy_(plan.x)
        plan.at_h.copy_(at.reshape(plan.at_h.shape))
        plan.style_h.copy_(style.reshape(plan.style_h.shape))
        plan.graph.replay()
        return plan.x.clone().reshape(x_init.shape)


def make_fused_ddim_window(mdm: MDM, diffusion, *, weights_dtype=torch.bfloat16, mesh=None):
    """K1 as JAX's ``make_fused_ddim_window`` returns it: without ``mesh``
    a :class:`FusedDDIMWindow`; with a single-process ``mesh``
    (:mod:`~syntalker_tpu_torch.parallel.mesh`) a callable ``(x_init, cond)
    -> [x]`` that splits the batch into the data shards and runs each on
    its device through that device's own ``FusedDDIMWindow`` (its weights
    and graphs; one for each distinct device, so the shards of a device
    take turns replaying it), returning the shards' results in data order.
    JAX's mesh form needs no collectives either."""
    if mesh is None:
        return FusedDDIMWindow(mdm, diffusion, weights_dtype=weights_dtype)
    from syntalker_tpu_torch.parallel.mesh import replicate, shard_batch

    windows = {device: FusedDDIMWindow(m, diffusion, weights_dtype=weights_dtype)
               for device, m in replicate(mdm, mesh).items()}

    def run(x_init: torch.Tensor, cond: Conditioning) -> list:
        return [windows[device](x, c) for (_, device), (x, c) in zip(mesh.data_shards(),
                                                                    shard_batch((x_init, cond), mesh))]

    return run


class _WindowPlan:
    """K1 for one (B, T): the static buffers of a window (DDIM state in f32
    and bf16, the bf16 audio/word features and style rows, the slabs, the
    activation, the block stack's scratch) and the graph of the window's
    launches over them, with every step's coefficients as launch arguments."""

    def __init__(self, fused: FusedDDIMWindow, b: int, t: int, a_dim: int, dev: torch.device):
        cfg = fused.cfg
        c, d, rows = fused.w_in.shape[0], cfg.latent_dim, b * t
        steps = len(fused.coef_a)
        bf = torch.bfloat16
        self.x = torch.zeros(rows, c, device=dev)
        self.x_h = torch.zeros(rows, c, dtype=bf, device=dev)
        self.at_h = torch.zeros(rows, a_dim, dtype=bf, device=dev)
        self.style_h = torch.zeros(steps * b, d, dtype=bf, device=dev)
        at_p = torch.zeros(rows, d, device=dev)
        style_p = torch.zeros(steps * b, d, device=dev)
        x_emb = torch.zeros(rows, d, dtype=bf, device=dev)
        xe_p = torch.zeros(rows, d, device=dev)
        act = torch.zeros(rows, d, device=dev)
        act_h = torch.zeros(rows, d, dtype=bf, device=dev)
        bufs = _block_buffers(rows, d, fused.blocks["wfc1"].shape[-1], dev)
        cos_t, sin_t = fused.rope_tables(t, dev)
        ln1 = (fused.blocks["ln1_s"][0], fused.blocks["ln1_b"][0])
        style_rows = [style_p[it * b : (it + 1) * b] for it in range(steps)]

        def record(L: _Launcher):
            L.gemm(self.at_h, fused.w2_at, EPI_STORE, out_f=at_p)
            L.gemm(self.style_h, fused.w2_style, EPI_STORE, out_f=style_p)
            for it in range(steps):
                L.gemm(self.x_h, fused.w_in, EPI_BIAS_BF16, bias=fused.b_in, out_h=x_emb)
                L.gemm(x_emb, fused.w2_x, EPI_STORE, out_f=xe_p)
                L.prologue(style_rows[it], xe_p, at_p, fused.b_in2, cos_t, sin_t, act, ln1, bufs[0],
                           b, t, d, cfg.rope_heads)
                L.blocks(act, fused.blocks, b, t, cfg.num_heads, bufs, x_h=act_h, first_ln_done=True)
                L.gemm(act_h, fused.w_out, EPI_DDIM, bias=fused.b_out, out_f=self.x, out_h=self.x_h,
                       ca=fused.coef_a[it], cb=fused.coef_b[it])

        self.graph = _Replay("ddim_window", dev, record)
