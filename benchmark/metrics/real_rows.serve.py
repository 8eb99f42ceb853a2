"""Share of the denoiser's sample rows that belong to requests, %: the
program's counters ``serve.sample_rows_real`` over ``serve.sample_rows``
(a group's ``max_batch`` rows, and its real ones, times its guidance
branches)."""


def read(s: dict):
    c = s.get("program", {}).get("counts", {})
    return 100.0 * c["serve.sample_rows_real"] / c["serve.sample_rows"] if c.get("serve.sample_rows") else None
