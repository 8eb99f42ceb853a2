"""K3's share of its roofline in the stream: the bound of the decode's
residual snap of every part over the device time of the kernels launched
inside the benchmark's span around the snap
(``models.rvqvae.rvq_quantize_eval_fused``)."""


def read(s: dict):
    dev = s.get("span_device_s", {}).get("snap")
    bound = s.get("bound_s", {}).get("k3")
    return 100.0 * bound / dev if dev and bound else None
