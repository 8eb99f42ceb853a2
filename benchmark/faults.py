"""Faults planted in the timed path, each a function ``fault(patch)`` that
breaks the program through ``patch(owner, name, value)`` (pytest's
``monkeypatch.setattr``, or :func:`patcher`). A judge must call each run
they are planted in not correct; ``benchmark/tests/test_bench_cpu_runs.py``
holds every cell to the faults it can have, and ``calibrate.py --fault``
reads a fault's numbers at a cell's own size."""

from __future__ import annotations


def unchanged_state(patch) -> None:
    """The samplers' steps leave their state as it came (the noise)."""
    from syntalker_tpu_torch import generation
    from syntalker_tpu_torch.ops import mdm_cuda

    patch(mdm_cuda.FusedDDIMWindow, "__call__", lambda self, x_init, cond: x_init.float().clone())
    patch(generation, "sample", lambda diffusion, model_fn, noise, **kw: noise.clone())


def half_batch(patch) -> None:
    """Half the batch left out: the service answers every other row of a
    group with its neighbour's motion."""
    from syntalker_tpu_torch import generation

    decode = generation.decode_latents

    def half_decode(latents, **kw):
        out = latents.clone()
        out[1::2] = latents[0::2][: len(out[1::2])]
        return decode(out, **kw)

    patch(generation, "decode_latents", half_decode)


def altered_answer(patch) -> None:
    """The decode's motion altered where it is produced: the left shoulder
    turned by 0.1 rad in every frame."""
    from syntalker_tpu_torch import generation

    decode_parts = generation.decode_parts

    def altered(parts, **kw):
        out = decode_parts(parts, **kw)
        out["axis_angle"][..., 48:51] += 0.1
        return out

    patch(generation, "decode_parts", altered)


FAULTS = {f.__name__: f for f in (unchanged_state, half_batch, altered_answer)}


def patcher():
    """(patch, undo) for use outside pytest."""
    undo = []

    def patch(owner, name, value):
        undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def restore():
        while undo:
            setattr(*undo.pop())

    return patch, restore

