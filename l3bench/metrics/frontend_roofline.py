"""Share of its roofline that the front-end kernel reaches, in %: the
least time of the function (``counts.frontend_bound_s``: the real FFT of
each frame and the sparse mel sum at the precision's peak, or the PCM the
clip's real windows cover read once and their features written once at the
HBM rate, the larger), summed over the traced clips, over the device time
of the kernel's launches in the traced stretch (the whole function: the
DFT or FFT kernel and, for mel, its dB pass). The kernels are found by
their names, by the configuration's front end and the cell's precision."""

from l3bench import counts

KERNELS = {("mel", True): ("mel_dft_kernel", "db_finalize_kernel"),
           ("mel", False): ("mel_fft_kernel", "db_finalize_kernel"),
           ("linear", True): ("spec_dft_kernel",),
           ("linear", False): ("spec_fft_kernel",)}


def read(rec):
    trace, clips = rec.get("trace"), rec.get("trace_clips", [])
    if not trace or not clips:
        return None
    fast = rec["cell"]["precision"] == "bf16"
    names = KERNELS.get((rec["config"]["audio"]["frontend"], fast))
    if names is None:
        return None
    launches = sum(v for k, v in trace["calls"].items() if names[0] in k)
    if launches != len(clips):  # a launch the harness cannot assign to a clip
        return None
    seconds = sum(v for k, v in trace["ops"].items() if any(n in k for n in names))
    bound = sum(counts.frontend_bound_s(c["rows"], rec["config"], fast, c.get("span")) for c in clips)
    return 100.0 * bound / seconds if seconds > 0 else None
