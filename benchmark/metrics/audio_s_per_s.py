"""Audio seconds of the PCM hops received inside the window, over the
window's seconds."""
from benchmark.lib.stats import audio_rate


def read(run):
    return audio_rate(run.records, run.t0, run.t1, run.hop_audio_s)
