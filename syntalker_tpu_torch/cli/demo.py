"""Demo: speech audio in, a generated motion video out.

Usage: python -m syntalker_tpu_torch.cli.demo -c configs/diffusion_beat2.yaml \
           --wav input.wav [test_ckpt=... rvq_ckpts=[...]] [--device cpu]

Counterpart of ``syntalker_tpu/cli/demo.py``. With ``--wav`` it runs once:
the optional transcription (the port's own Whisper,
:mod:`~syntalker_tpu_torch.models.whisper`, from a local Hugging Face
snapshot directory given by ``--whisper-path``; without one the words are
silence and the denoiser runs on the audio alone), then ``generate --render``,
which writes ``demo_out.npz`` and its stick-figure video under
``--run-dir``. Without ``--wav`` it serves a Gradio page where that package
is installed and exits with a message where it is not. Runs on CUDA unless
``--device cpu``.
"""

from __future__ import annotations

import logging
import tempfile
from pathlib import Path

from syntalker_tpu_torch.cli.common import base_parser, setup

log = logging.getLogger("syntalker")


def transcribe_if_available(wav_path: str, whisper_path: str = "", device=None) -> str:
    """The transcript of the wav, or "" without a snapshot. ``whisper_path``
    is a local Hugging Face snapshot directory (``config.json``,
    ``model.safetensors``; ``vocab.json`` for the text, without which each
    token id is a word); nothing is downloaded. Each 30 s of the clip is one
    row of one greedy batch."""
    if not whisper_path:
        return ""
    from syntalker_tpu_torch.data.audio import load_wav_mono
    from syntalker_tpu_torch.models.whisper import N_SAMPLES, SAMPLE_RATE, load_snapshot

    asr = load_snapshot(whisper_path, device=device)
    y, _ = load_wav_mono(wav_path, SAMPLE_RATE)
    chunks = [y[i : i + N_SAMPLES] for i in range(0, max(len(y), 1), N_SAMPLES)]
    tokens = asr.transcribe(chunks, [asr.max_new_tokens] * len(chunks))
    return " ".join(w for t in tokens for w in asr.words(t))


def run_one(cfg_path, overrides, wav_path, prompts, run_dir, transcript="", device=None) -> str:
    """``generate --render`` of one wav into ``run_dir``; returns the video's path."""
    from syntalker_tpu_torch.cli import generate as gen_cli

    out = Path(run_dir) / "demo_out.npz"
    argv = (["-c", cfg_path] if cfg_path else []) + ["--wav", wav_path, "--out", str(out), "--render",
                                                     "--run-dir", run_dir]
    if transcript:
        argv += ["--transcript", transcript]
    for part, text in (prompts or {}).items():
        if text:
            argv += [f"--{part}-prompt", text]
    if device:
        argv += ["--device", device]
    gen_cli.main(argv + list(overrides))
    video = out.with_suffix(".mp4")
    return str(video if video.exists() else out.with_suffix(".gif"))


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--wav", type=str, default="", help="one-shot mode input")
    p.add_argument("--whisper-path", type=str, default="", help="local whisper snapshot for ASR (optional)")
    p.add_argument("--share", action="store_true")
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    setup(args)

    if args.wav:  # one-shot mode
        text = transcribe_if_available(args.wav, args.whisper_path, args.device)
        video = run_one(args.config, args.overrides, args.wav, {}, args.run_dir, transcript=text, device=args.device)
        log.info(f"demo output: {video}")
        return video

    try:
        import gradio as gr
    except ImportError:
        raise SystemExit("gradio is not installed; run one-shot mode with --wav input.wav")

    def fn(audio_file, upper, hands, lower):
        text = transcribe_if_available(audio_file, args.whisper_path, args.device)
        return run_one(args.config, args.overrides, audio_file, {"upper": upper, "hands": hands, "lower": lower},
                       tempfile.mkdtemp(), transcript=text, device=args.device)

    gr.Interface(
        fn=fn,
        inputs=[gr.Audio(type="filepath", label="speech audio"), gr.Textbox(label="upper-body prompt (optional)"),
                gr.Textbox(label="hands prompt (optional)"), gr.Textbox(label="lower-body prompt (optional)")],
        outputs=gr.Video(label="generated motion"),
        title="SynTalker-TPU",
    ).launch(share=args.share)


if __name__ == "__main__":
    main()
