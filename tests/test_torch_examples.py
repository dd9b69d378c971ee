"""The port's example entry points (``mojo_opset_tpu_torch.examples``) on
the CPU, each through ``main([... "--device", "cpu"])``: the greedy
``llm_inference`` returns the ids of the port's ``MojoGenerator`` called
directly on the same model; its int8 modes and speculative decoding run;
the debugger, chrome-trace and profiler flags write what they say;
``continuous_serving`` serves each request as the batcher alone does; and
``dit_inference`` denoises and decodes.
"""

import json

import numpy as np
import pytest
import torch

from mojo_opset_tpu_torch.examples import continuous_serving, dit_inference, llm_inference
from mojo_opset_tpu_torch.runtime import ContinuousBatchingGenerator, GreedySampler, MojoGenerator
from mojo_opset_tpu_torch.runtime import PagedAttentionGenerationModel
from mojo_opset_tpu_torch.utils.debugger import MojoDebugger

CPU = ["--device", "cpu"]
TINY = ["--tiny", *CPU, "--max-new-tokens", "6"]


@pytest.fixture(autouse=True)
def _debugger_off():
    yield
    MojoDebugger.disable()


def _direct_greedy(argv):
    """The same model through MojoGenerator, not through the example."""
    args = llm_inference._parser().parse_args(argv)
    model = llm_inference.build_model(args)
    tokenizer = llm_inference._FallbackTokenizer()
    ids = np.asarray(tokenizer(args.prompt).input_ids[0], np.int32)
    gen = MojoGenerator(PagedAttentionGenerationModel(model, block_size=args.block_size), tokenizer,
                        GreedySampler(), max_new_tokens=args.max_new_tokens)
    return gen.generate_from_ids(ids, np.array([ids.size], np.int32))


def test_llm_inference_greedy_equals_the_generator(capsys):
    result = llm_inference.main([*TINY, "--greedy"])
    assert result["ids"].shape == (1, 6) and result["allocator"] == "native"
    np.testing.assert_array_equal(result["ids"], _direct_greedy([*TINY, "--greedy"]))
    printed = capsys.readouterr().out
    assert f"decoded: {result['decoded']}" in printed and "allocator: native" in printed
    fused = llm_inference.main([*TINY, "--greedy", "--fused"])
    np.testing.assert_array_equal(fused["ids"], result["ids"])


@pytest.mark.parametrize("flags", [["--quant", "w8a8", "--quant-kv"], ["--speculative", "4"], []],
                         ids=["w8a8_c8", "speculative", "topk"])
def test_llm_inference_modes_run(flags):
    result = llm_inference.main([*TINY, *([] if not flags else ["--greedy"]), *flags])
    assert result["ids"].shape == (1, 6) and result["ids"].dtype == np.int32
    assert ((result["ids"] >= 0) & (result["ids"] < 32000)).all()
    if "--speculative" in flags:  # greedy speculative decoding is lossless
        np.testing.assert_array_equal(result["ids"], _direct_greedy([*TINY, "--greedy"]))
        assert result["rounds"] >= 1


def test_llm_inference_tooling_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(MojoDebugger, "dump_dir", str(tmp_path / "dumps"))
    plain = llm_inference.main([*TINY, "--greedy"])
    result = llm_inference.main([*TINY, "--greedy", "--debug-compare", "0:*,3:*", "--debug-dump", "0:RMSNorm",
                                 "--trace-out", str(tmp_path / "spans.json"),
                                 "--profile-dir", str(tmp_path / "profile")])
    np.testing.assert_array_equal(result["ids"], plain["ids"])  # log mode and tracing change nothing
    forwards = result["ids"].shape[1]  # the prefill and one decode step a later token
    # a forward's records at occurrences 0 and 3: two norms, two RoPEs (q, k), two attentions
    assert result["debug"]["counts"] == {"compare": 8 * forwards, "dump": forwards, "errors": 0}
    assert all(r["max_abs"] <= 1e-5 for r in result["debug"]["records"])
    assert len(list((tmp_path / "dumps" / "rank0").glob("RMSNorm_L0_*.npz"))) == forwards
    spans = json.loads((tmp_path / "spans.json").read_text())["traceEvents"]
    names = [(e["name"], e["ph"]) for e in spans]
    # the runtime's spans: one call, one prefill, one decode step a later token
    assert (names.count(("llm_inference", "E")), names.count(("mojo.generate", "E")),
            names.count(("mojo.prefill", "E")), names.count(("mojo.decode_step", "E"))) == (1, 1, 1, forwards - 1)
    assert result["profile"] == [str(tmp_path / "profile" / "trace.json")]
    assert json.loads((tmp_path / "profile" / "trace.json").read_text())["traceEvents"]
    assert not MojoDebugger.enabled()


def test_continuous_serving_serves_each_request_as_the_batcher_does():
    argv = [*CPU, "--requests", "3", "--slots", "2", "--max-new-tokens", "4", "--trace-out", "/dev/null"]
    result = continuous_serving.main(argv)
    assert result["tokens"] == 12 and result["tokens_per_s"] > 0
    model = llm_inference.build_model(llm_inference._parser().parse_args(["--tiny", *CPU]))
    gen = ContinuousBatchingGenerator(model, batch_slots=2, block_size=32, max_new_tokens=4)
    rng = np.random.default_rng(0)
    rids = [gen.submit(rng.integers(1, 32000, (int(n),)).astype(np.int32)) for n in rng.integers(4, 48, (3,))]
    want = gen.run()
    for rid in rids:
        np.testing.assert_array_equal(result["requests"][rid], want[rid])


def test_dit_inference_denoises_and_decodes(tmp_path):
    result = dit_inference.main([*CPU, "--steps", "2", "--dim", "64", "--layers", "1", "--decode-vae",
                                 "--trace-out", str(tmp_path / "dit.json")])
    assert result["latent"].shape == (16, 2, 8, 8) and torch.isfinite(result["latent"]).all()
    assert result["video"].shape == (1, 3, 3, 32, 32) and torch.isfinite(result["video"]).all()
    assert len(result["elapsed_seconds"]) == 2
    names = [e["name"] for e in json.loads((tmp_path / "dit.json").read_text())["traceEvents"]]
    assert names.count("step") == 4 and "vae_decode" in names
