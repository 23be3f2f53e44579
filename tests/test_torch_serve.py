"""The port's serving CLI (``repro_torch.launch.serve``) on the CPU.

Every run passes ``--device cpu`` (the CLI serves on CUDA by default).
Validation fails before any model work with the reference CLI's error
type and message, case by case (``tests/test_examples.py``'s cases, both
CLIs run on the same argv).  The data-parallel, streaming, class-mix,
trace-replay and long-shared-prefix runs all finish with zero lost (the
CLI asserts it), and the closed-loop fleet run makes the reference CLI's
scheduling decisions: its workload is drawn from the same seed, and
without speculation the steps, commits, preemptions and clock do not
depend on the tokens (the two CLIs' random weights differ).
"""

import pytest
import torch

from repro.launch.serve import main as jmain
from repro_torch.launch.serve import main
from repro_torch.serving import dump_trace, synthesize_trace

torch.set_num_threads(1)

TINY = ["--num-pages", "24", "--page-size", "4", "--max-batch", "2",
        "--prompt-len", "6", "--max-new", "3"]
CPU = ["--device", "cpu"]

BAD = {
    "unknown_class": ["--classes", "vip:1.0"],
    "zero_weight": ["--classes", "interactive:0"],
    "no_colon": ["--classes", "interactive"],
    "bad_number": ["--classes", "interactive:lots"],
    "duplicate": ["--classes", "interactive:1,interactive:2"],
    "empty": ["--classes", " , "],
    "classes_with_trace": ["--classes", "interactive:1", "--trace",
                           "x.jsonl"],
    "trace_with_replicas": ["--trace", "x.jsonl", "--replicas", "2"],
    "missing_trace": ["--trace", "does-not-exist.jsonl"],
    "stream_with_replicas": ["--stream", "--replicas", "2"],
    "tp_below_one": ["--tp", "0"],
}


def _raised(fn, argv):
    with pytest.raises(Exception) as info:
        fn(argv)
    return type(info.value), str(info.value)


@pytest.mark.parametrize("case", list(BAD))
def test_validation_fails_fast_like_the_reference(case):
    got = _raised(main, BAD[case] + CPU)
    assert got[0] in (ValueError, FileNotFoundError), got
    assert got == _raised(jmain, BAD[case])


def test_cuda_default_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--requests", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--requests", "2", "--device", "cuda:0"])


@pytest.mark.parametrize("arch", ["mamba2-780m", "whisper-tiny"])
def test_unported_family_names_the_roadmap(arch):
    """A family with no paged serving path (in the reference too) is
    refused before any model work, naming where its model ports."""
    with pytest.raises(ValueError, match="decoder LMs.*A.6b"):
        main(["--arch", arch, "--requests", "2"] + CPU)


@pytest.mark.parametrize("arch,tp", [("olmoe-1b-7b", 1), ("olmoe-1b-7b", 2),
                                     ("paligemma-3b", 2)])
def test_moe_and_vlm_archs_serve(capsys, arch, tp):
    """MoE and the VLM's text decoder serve at the reduced size, at TP=1
    and over two shards (paligemma's one KV head: the replicated arena)."""
    stats = main(["--arch", arch, "--reduced", "--requests", "3", "--tp",
                  str(tp)] + TINY + CPU)
    tag = "[serve]" if tp == 1 else f"[serve x1 tp{tp}]"
    assert f"{tag} finished 3/3 requests" in capsys.readouterr().out
    assert stats.tokens_committed > 0


def _sched(stats):
    return (stats.steps, stats.tokens_committed, stats.preemptions,
            stats.warnings_fired, stats.pages_reclaimed)


def test_replicas_flag_serves_a_fleet_like_the_reference(capsys):
    argv = ["--requests", "4", "--replicas", "2"] + TINY
    stats = main(argv + CPU)
    out = capsys.readouterr().out
    assert "[serve x2] finished 4/4 requests" in out
    assert stats.superblocks_resident > 0  # anchors aggregate across pools
    assert _sched(stats) == _sched(jmain(argv))


def test_stream_and_class_mix(capsys):
    stats = main(["--requests", "3", "--stream", "--classes",
                  "interactive:0.7,batch:0.3"] + TINY + CPU)
    out = capsys.readouterr().out
    assert stats.tokens_committed > 0
    assert "+1 tokens" in out  # incremental yields reached the console
    assert "class interactive" in out and " p99=" in out
    assert sum(cs.finished for cs in stats.class_stats.values()) == 3


def test_trace_replay_end_to_end(tmp_path):
    events = synthesize_trace(3, duration_s=1.0, rate_rps=8.0,
                              class_mix={"interactive": 0.6, "batch": 0.4},
                              prompt_mean=5, max_new_mean=3,
                              prompt_cap=8, max_new_cap=4)
    path = tmp_path / "trace.jsonl"
    dump_trace(events, str(path))
    stats = main(["--num-pages", "32", "--page-size", "4", "--max-batch",
                  "2", "--trace", str(path)] + CPU)
    assert stats.class_stats
    assert sum(cs.finished for cs in stats.class_stats.values()) == \
        len(events)


def test_shared_prefix_longer_than_prompt_len():
    stats = main(["--requests", "3", "--prefix-cache", "--shared-prefix",
                  "16"] + TINY + CPU)
    assert stats.prefix_hits > 0


def test_tensor_parallel_fleet_on_one_named_device(capsys):
    """``--tp 2 --replicas 2`` on one named device: a 2D fleet of four
    shards on it."""
    stats = main(["--requests", "4", "--replicas", "2", "--tp", "2"]
                 + TINY + CPU)
    assert "[serve x2 tp2] finished 4/4 requests" in capsys.readouterr().out
    assert stats.tokens_committed > 0
