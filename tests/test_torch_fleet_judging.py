"""``chip_smoke.py`` phase 18's judging of a resumed direct stream
(``stream_stretches``): a stream that resumed past its last pushed
checkpoint can splice two runs, where the resumed run re-generated a
delivered token otherwise; each stretch is then held to the calm replay
as the run that sampled it. The case below is the one an H100 run met:
the client held tokens 0-4 of a killed run, the resumed run started from
a 3-token checkpoint, re-generated token 4 otherwise and sent the rest."""

import pytest

import chip_smoke

PROMPT = (11, 12, 13)
KILLED = [60562, 3265, 80327, 10588, 80327, 112257]
RESUMED = [60562, 3265, 80327, 10588, 3265, 80327, 3265, 80327] + [9] * 24
SPLICE = KILLED[:5] + RESUMED[5:]


def _run(gen, start, tag="fleet", prompt=PROMPT):
    """One ``SampleTrace.runs()`` entry: every token from ``start`` sampled."""
    return (tag, prompt, list(gen), start, {j: None for j in range(start, len(gen))})


def test_an_unspliced_stream_is_one_output():
    runs = [_run(KILLED, 0), _run(KILLED[:5] + [7] * 27, 3), _run(RESUMED, 0, "calm")]
    ids = KILLED[:5] + [7] * 27
    assert chip_smoke.stream_stretches(runs, PROMPT, ids, [5], "stream 5") == [
        (PROMPT, ids, "stream 5")]


def test_a_spliced_stream_is_held_as_the_runs_that_sampled_it():
    runs = [_run(KILLED, 0), _run(RESUMED, 3), _run(RESUMED, 0, "calm")]
    out = chip_smoke.stream_stretches(runs, PROMPT, SPLICE, [5], "stream 5")
    assert [o[1] for o in out] == [KILLED[:5], RESUMED]
    assert "re-generated token 4 as 3265, the stream holds 80327" in out[1][2]


@pytest.mark.parametrize("runs", [
    [_run(KILLED, 0)],                              # nothing sampled tokens 5-31
    [_run(KILLED, 0), _run(RESUMED, 6)],            # the run began after the resume
    [_run(KILLED, 0), _run(RESUMED, 3, prompt=(1,))],   # another prompt's run
])
def test_a_stretch_no_traced_run_sampled_fails(runs):
    with pytest.raises(AssertionError, match="no traced run sampled its tokens 5-31"):
        chip_smoke.stream_stretches(runs, PROMPT, SPLICE, [5], "stream 5")
