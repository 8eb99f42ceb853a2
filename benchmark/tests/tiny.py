"""A cell at tiny widths on the CPU: the drivers' code paths through the
kernels' plain versions, in seconds."""

import copy
import time

import torch

from benchmark import harness

MDM = dict(latent_dim=32, ff_size=64, num_layers=2, num_heads=2, rope_heads=4, audio_feat_dim=16, word_feat_dim=16,
           vocab_size=64, prompt_dim=16)
RVQ = dict(width=16, depth=1, num_quantizers=2, nb_code=32)
TRAFFIC = {"beat2-stream": dict(utterance_s=20.0, judged_windows=5),
           "h3d-serve-prompted": dict(pool_buckets=2, warm_buckets=1)}
SECONDS = {"beat2-stream": 1.0, "h3d-serve-prompted": 2.0}


def ctx(name: str, seed: int = 3, trace: bool = False) -> harness.Ctx:
    c = harness.context(name, seed, SECONDS[name], trace, torch.device("cpu"), time.perf_counter())
    c.config = copy.deepcopy(c.config)
    c.config["mdm"].update(MDM)
    c.config["rvq"].update(RVQ)
    c.config["diffusion"]["respacing"] = "ddim4"
    c.traffic = dict(c.traffic, **TRAFFIC[name])
    return c
