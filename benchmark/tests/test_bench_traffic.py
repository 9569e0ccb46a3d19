"""The traffic generator follows its mix files and is reproducible."""
import numpy as np
import pytest

from benchmark.lib import spec, traffic

MIXES = ("chat", "clone", "read", "chat_greedy", "clone_greedy", "read_greedy")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = spec.load_mix(name)
    a, b = traffic.plan(mix, 2**31 + 11, 20, 8), traffic.plan(mix, 2**31 + 11, 20, 8)
    assert [(i.at, i.prompt, i.frames, i.greedy, i.seed) for i in a["items"]] == \
        [(i.at, i.prompt, i.frames, i.greedy, i.seed) for i in b["items"]]


@pytest.mark.parametrize("name", MIXES)
def test_seeds_share_sizes_not_order(name):
    mix = spec.load_mix(name)
    a, b = traffic.plan(mix, 1, 20, 8), traffic.plan(mix, 2**33 + 5, 20, 8)
    assert sorted(i.frames for i in a["items"]) == sorted(i.frames for i in b["items"])
    assert sorted(len(i.prompt) for i in a["items"]) == sorted(len(i.prompt) for i in b["items"])
    assert [i.prompt for i in a["items"]] != [i.prompt for i in b["items"]]
    assert [i.at for i in a["items"]] == [i.at for i in b["items"]]
    block = mix.get("permute_block", 0)
    if block:  # the same (prompt, output) pairs in each block, in another order
        pairs = [[(len(i.prompt), i.frames) for i in p["items"]] for p in (a, b)]
        for k in range(0, len(pairs[0]), block):
            assert sorted(pairs[0][k:k + block]) == sorted(pairs[1][k:k + block])


@pytest.mark.parametrize("name", MIXES)
def test_sizes_follow_the_mix(name):
    mix = spec.load_mix(name)
    p = traffic.plan(mix, 5, 30, 8)
    lo, hi = traffic.prompt_range(mix)
    of = mix["output_frames"]
    for i in p["items"]:
        assert lo <= len(i.prompt) <= hi
        assert of["min"] <= i.frames <= of["max"] and i.max_tokens == 7 * i.frames
        assert i.prompt[0] == traffic.START_OF_HUMAN
        assert i.prompt[-4:] == [traffic.END_OF_TEXT, traffic.END_OF_HUMAN,
                                 traffic.START_OF_AI, traffic.START_OF_SPEECH]
    greedy = [i.greedy for i in p["items"]]
    assert sum(greedy) == -(-len(greedy) // mix["greedy_every"])


def test_open_loop_arrivals():
    mix = spec.load_mix("chat")
    p = traffic.plan(mix, 3, 30, 16)
    ats = [i.at for i in p["items"]]
    assert p["loop"] == "open" and len(ats) == round(mix["arrival"]["rate_per_s"] * 30)
    assert ats == sorted(ats) and ats[0] == 0.0 and ats[-1] < 30


def test_bursts_arrive_together():
    mix = spec.load_mix("chat")
    mix["arrival"]["burst"] = 4
    p = traffic.plan(mix, 3, 20, 16)
    ats = [i.at for i in p["items"]]
    assert len(ats) == 4 * round(mix["arrival"]["rate_per_s"] * 20)
    assert all(len(set(ats[k:k + 4])) == 1 for k in range(0, len(ats), 4))


def test_closed_loop_groups():
    mix = spec.load_mix("clone")
    p = traffic.plan(mix, 3, 20, 16)
    assert p["loop"] == "closed" and p["clients"] == 16 and p["burst"] == 4


def test_clone_reference_turn_is_banded_audio():
    mix = spec.load_mix("clone")
    item = traffic.plan(mix, 9, 5, 16)["items"][0]
    ids = np.asarray(item.prompt)
    audio = ids[(ids >= traffic.AUDIO_BASE)]
    pos = np.arange(audio.size) % 7
    code = audio - traffic.AUDIO_BASE - pos * traffic.CODEBOOK
    assert audio.size % 7 == 0 and audio.size >= 7 * 90
    assert ((code >= 0) & (code < traffic.CODEBOOK)).all()
    assert (ids[ids < traffic.AUDIO_BASE - 300] < traffic.TEXT_IDS).all()


def test_closed_loop_clients():
    mix = spec.load_mix("read")
    p = traffic.plan(mix, 3, 30, 8)
    assert p["loop"] == "closed" and p["clients"] == 8
    assert len(p["items"]) == mix["arrival"]["pool"]


def test_quantiles_lognormal_median_and_clip():
    q = traffic.quantiles({"median": 40, "sigma": 0.5, "min": 12, "max": 130}, 101)
    assert q[50] == 40 and q.min() >= 12 and q.max() <= 130
