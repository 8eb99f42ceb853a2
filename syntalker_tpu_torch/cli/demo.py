"""Demo: speech audio in, a generated motion video out.

Usage: python -m syntalker_tpu_torch.cli.demo -c configs/diffusion_beat2.yaml \
           --wav input.wav [test_ckpt=... rvq_ckpts=[...]] [--device cpu]

Counterpart of ``syntalker_tpu/cli/demo.py``. With ``--wav`` it runs once:
the optional transcription (whisper through ``transformers``, from a local
snapshot given by ``--whisper-path``; without one the words are silence
and the denoiser runs on the audio alone), then ``generate --render``,
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


def transcribe_if_available(wav_path: str, whisper_path: str = "") -> str:
    """The whisper transcript of the wav, or "" without a snapshot (or
    without ``transformers``)."""
    if not whisper_path:
        return ""
    try:
        from transformers import pipeline

        asr = pipeline("automatic-speech-recognition", model=whisper_path, local_files_only=True)
        return asr(wav_path)["text"]
    except Exception as e:  # a missing package, snapshot or file: the demo runs on the audio alone
        log.warning(f"ASR unavailable: {e}")
        return ""


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
        text = transcribe_if_available(args.wav, args.whisper_path)
        video = run_one(args.config, args.overrides, args.wav, {}, args.run_dir, transcript=text, device=args.device)
        log.info(f"demo output: {video}")
        return video

    try:
        import gradio as gr
    except ImportError:
        raise SystemExit("gradio is not installed; run one-shot mode with --wav input.wav")

    def fn(audio_file, upper, hands, lower):
        return run_one(args.config, args.overrides, audio_file, {"upper": upper, "hands": hands, "lower": lower},
                       tempfile.mkdtemp(), transcript=transcribe_if_available(audio_file, args.whisper_path),
                       device=args.device)

    gr.Interface(
        fn=fn,
        inputs=[gr.Audio(type="filepath", label="speech audio"), gr.Textbox(label="upper-body prompt (optional)"),
                gr.Textbox(label="hands prompt (optional)"), gr.Textbox(label="lower-body prompt (optional)")],
        outputs=gr.Video(label="generated motion"),
        title="SynTalker-TPU",
    ).launch(share=args.share)


if __name__ == "__main__":
    main()
