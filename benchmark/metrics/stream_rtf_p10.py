"""10th percentile over the requests sent in the window of each one's
audio seconds over the seconds from its first hop to its last; a failed
request counts 0."""
from benchmark.lib.stats import nearest_rank, stream_rtf


def read(run):
    return nearest_rank(stream_rtf(run.records, run.hop_audio_s), 10) if run.records else None
