"""Seconds from the process's start to the first request sent: kernel
build or load, weights, quantization, the engine, the warmup, one warm
request."""


def read(run):
    return run.setup_s
