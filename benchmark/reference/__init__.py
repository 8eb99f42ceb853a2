"""The benchmark's plain reference of the audio->motion path.

Plain PyTorch (float32, TF32 off) and numpy, written from the published
architecture and following the port's plain versions: it imports nothing of
the program and reads nothing the program made. It works from the weight
tensors, statistics and inputs that the benchmark itself makes from the seed.

- ``precision``: the rounding a control runs at (fp8 for bf16 kernels, TF32
  for float32 work);
- ``audio``: the 16 kHz amplitude-envelope + onset featurization;
- ``schedule``: the cosine schedule respaced for DDIM;
- ``mdm``: the MDM denoiser (wav encoder, word path, timestep MLP, the
  8-block transformer with RoPE) over a weight dict;
- ``sampler``: eta=0 DDIM windows, unprompted and with the per-body-part CFG;
- ``decode``: the residual-VQ snap (float64, near ties enumerated), the
  RVQ-VAE decoder, denormalization and the rotations.
"""
