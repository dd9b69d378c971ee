"""The generator and runtime surface of the port on the CPU: torch forms of
the JAX package's tests/base/test_generator_behavior.py (EOS masking, the
hook bus, the typewriter, ``__call__``, ``silent``) and
tests/base/test_deterministic.py (``MOJO_DETERMINISTIC=1``), and the
examples that load HF checkpoints (``llm_inference --checkpoint
--tokenizer``, ``dit_inference --ckpt-dir``, ``qwen3_patch
--tiny-selftest``).

Tolerances, and why: token streams, sampled draws and typewriter text are
compared exactly; the checkpoint examples hold to transformers' greedy
tokens exactly and ``qwen3_patch --verify`` to its logits within its own
5e-2, as JAX's example does.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mojo_opset_tpu.runtime import generation as jax_generation
from mojo_opset_tpu_torch.backends import enable_deterministic
from mojo_opset_tpu_torch.core.operators.sampling import MojoTopKSampling
from mojo_opset_tpu_torch.examples import dit_inference, llm_inference, qwen3_patch
from mojo_opset_tpu_torch.modeling.wan2_2 import WanConfig, WanModel
from mojo_opset_tpu_torch.runtime import GeneratorHook, GreedySampler, MojoGenerator, MojoRunTimeConfig, TopKSampler
from mojo_opset_tpu_torch.runtime.generation import _Typewriter
from mojo_opset_tpu_torch.utils.patching import wan_dit_rename_hook
from mojo_opset_tpu_torch.utils.platform import is_deterministic

REPO = Path(__file__).resolve().parents[1]


class _ScriptedModel:
    """Returns logits that force a given per-step token schedule."""

    def __init__(self, schedule, vocab=16):
        # schedule: list over steps of per-batch token ids; step 0 = prefill
        self.schedule = np.asarray(schedule)
        self.vocab = vocab
        self.calls = 0
        self.inputs = []
        self.model = torch.nn.Linear(1, 1)  # the generator draws on its parameters' device

    def __call__(self, input_ids, context_input_len=None, session=None):
        self.inputs.append((np.asarray(input_ids), None if context_input_len is None else np.asarray(context_input_len)))
        toks = self.schedule[self.calls]
        out = torch.full((len(toks), self.vocab), -1e9)
        out[torch.arange(len(toks)), torch.as_tensor(toks)] = 0.0
        self.calls += 1
        return out, object()


class _Tok:
    eos_token_id = 9

    def decode(self, ids):
        return "".join(chr(97 + int(i) % 26) for i in np.atleast_1d(ids))


def _gen(model, sampler=None, **kw):
    return MojoGenerator(model, _Tok(), sampler or GreedySampler(), **kw)


def _run(model, steps, batch=1, **kw):
    return _gen(model, **kw.pop("gen_kw", {})).generate_from_ids(np.zeros(batch, np.int32), np.ones(batch, np.int32),
                                                                 max_decode_steps=steps, **kw)


def test_eos_masks_remaining_tokens_per_sequence():
    # seq0 hits EOS at step 1; seq1 keeps generating
    out = _run(_ScriptedModel([[3, 4], [9, 5], [7, 6], [8, 7]]), 4, batch=2, silent=True)
    np.testing.assert_array_equal(out[0], [3, 9, 9, 9])  # frozen at EOS
    np.testing.assert_array_equal(out[1], [4, 5, 6, 7])


def test_early_stop_when_all_sequences_end():
    model = _ScriptedModel([[3], [9], [1], [2]])
    out = _run(model, 4, silent=True)
    np.testing.assert_array_equal(out, [[3, 9]])  # the batch-ending EOS step is emitted, then the loop stops
    assert model.calls == 2


def test_ignore_eos_keeps_generating():
    model = _ScriptedModel([[9], [9], [9], [9]])
    np.testing.assert_array_equal(_run(model, 4, ignore_eos=True, silent=True)[0], [9, 9, 9, 9])
    assert model.calls == 4


def test_missing_eos_token_disables_masking():
    class NoEos:
        eos_token_id = None

    gen = MojoGenerator(_ScriptedModel([[2], [3], [4]]), NoEos(), GreedySampler())
    out = gen.generate_from_ids(np.zeros(1, np.int32), np.ones(1, np.int32), max_decode_steps=3, silent=True)
    np.testing.assert_array_equal(out[0], [2, 3, 4])


def test_hook_bus_order_and_payloads():
    events = []

    class Rec(GeneratorHook):
        def before_prefill(self, *, input_ids, context_input_len):
            events.append(("before_prefill", len(input_ids)))

        def after_prefill(self, *, logits, session):
            events.append(("after_prefill", logits.shape[0]))

        def before_decode(self):
            events.append(("before_decode",))

        def after_decode_step(self, *, step, logits, next_token_id):
            events.append(("step", step))

        def after_decode(self, *, decode_steps, generated_ids):
            events.append(("after_decode", decode_steps, len(generated_ids)))

    _gen(_ScriptedModel([[1], [2], [3]]), hooks=[Rec()]).generate_from_ids(
        np.zeros(3, np.int32), np.asarray([1, 1, 1], np.int32), max_decode_steps=3, silent=True)
    assert events[:3] == [("before_prefill", 3), ("after_prefill", 1), ("before_decode",)]
    assert [e for e in events if e[0] == "step"] == [("step", 1), ("step", 2)]
    assert events[-1] == ("after_decode", 2, 3)


def test_sampler_streams_are_deterministic():
    """Same seed -> same trajectory for a stochastic sampler."""
    sched = [[i % 7] for i in range(5)]

    def run(seed):
        gen = _gen(_ScriptedModel(sched), sampler=TopKSampler(3), seed=seed)
        return gen.generate_from_ids(np.zeros(1, np.int32), np.ones(1, np.int32), max_decode_steps=5,
                                     ignore_eos=True, silent=True)

    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a, b)
    assert a.shape == c.shape


def test_typewriter_streams_and_closes_as_jax(capsys):
    sends = [[np.asarray([[0, 1]]), np.asarray([[2, 3]])], [np.asarray([[4], [5]]).T]]
    printed = []
    for cls in (_Typewriter, jax_generation._Typewriter):
        tw = cls(_Tok())
        for s in sends:
            tw.send(s)
        tw.close()
        assert not tw._thread.is_alive()
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert "[0] abcdef" in printed[0] and printed[0].endswith("Generation is done.\n")


class _SpyTypewriter(_Typewriter):
    sent: list = []

    def send(self, generated_ids):
        type(self).sent.append(np.concatenate(generated_ids, axis=-1))
        super().send(generated_ids)


@pytest.mark.parametrize("eos_at", [None, 6])
def test_typewriter_sends_every_buffer_steps(monkeypatch, capsys, eos_at):
    """Every ``typewriter_buffer`` tokens, then the rest once the loop ends
    (a stop at EOS included); the text is the whole stream's."""
    monkeypatch.setattr("mojo_opset_tpu_torch.runtime.generation._Typewriter", _SpyTypewriter)
    _SpyTypewriter.sent = []
    sched = [[i + 1] for i in range(9)]
    if eos_at is not None:
        sched[eos_at] = [9]
    out = _run(_ScriptedModel(sched), 9, gen_kw=dict(enable_typewriter=True, typewriter_buffer=4))
    assert [s.shape[1] for s in _SpyTypewriter.sent] == ([4, 4, 1] if eos_at is None else [4, 3])
    np.testing.assert_array_equal(np.concatenate(_SpyTypewriter.sent, axis=1), out)
    printed = capsys.readouterr().out
    assert printed.endswith(_Tok().decode(out[0]) + "\nGeneration is done.\n")


def test_silent_and_fused_keep_the_typewriter_off(monkeypatch, capsys):
    monkeypatch.setattr("mojo_opset_tpu_torch.runtime.generation._Typewriter", _SpyTypewriter)
    _SpyTypewriter.sent = []
    _run(_ScriptedModel([[1]] * 6), 6, silent=True, gen_kw=dict(enable_typewriter=True, typewriter_buffer=2))
    _run(_ScriptedModel([[1]] * 6), 6, gen_kw=dict(enable_typewriter=False))
    assert _SpyTypewriter.sent == [] and capsys.readouterr().out == ""


def test_typewriter_reads_nothing_more_from_the_device(monkeypatch):
    """The typewriter takes the host copies the loop makes for EOS: the
    same number of ``.cpu()`` reads with it on and off."""
    reads = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: reads.append(1) or real(self, *a, **k))
    counts = []
    for typewriter in (False, True):
        reads.clear()
        _run(_ScriptedModel([[i + 1] for i in range(8)]), 8, ignore_eos=True,
             gen_kw=dict(enable_typewriter=typewriter, typewriter_buffer=3))
        counts.append(len(reads))
    assert counts[0] == counts[1] == 8


def test_call_tokenizes_and_packs_prompts(capsys):
    class Tok(_Tok):
        def __init__(self):
            self.seen = []

        def __call__(self, prompts, return_tensors=None):
            self.seen.append(prompts)

            class R:
                input_ids = [[5, 6], [7]][: len(prompts)]

            return R()

    model = _ScriptedModel([[1, 2], [3, 4]])
    tok = Tok()
    out = MojoGenerator(model, tok, GreedySampler())(["hello", "hi"], max_decode_steps=2, silent=True)
    assert out.shape == (2, 2)
    np.testing.assert_array_equal(model.inputs[0][0], [5, 6, 7])  # varlen packing
    np.testing.assert_array_equal(model.inputs[0][1], [2, 1])
    printed = capsys.readouterr().out
    assert printed.startswith("Prompt: ['hello', 'hi']\n" + "-" * 40)
    single = _ScriptedModel([[1], [3]])
    MojoGenerator(single, tok, GreedySampler())("hello", max_decode_steps=2, silent=True)
    assert tok.seen[-1] == ["hello"]  # one prompt goes in as a batch of one
    np.testing.assert_array_equal(single.inputs[0][1], [2])


def test_greedy_sampler_argmax_and_topk_support():
    logits = torch.tensor([[0.1, 3.0, -1.0], [2.0, 0.0, 1.0]])
    np.testing.assert_array_equal(GreedySampler()(logits).numpy(), [1, 0])
    np.testing.assert_array_equal(TopKSampler(1)(logits, generator=torch.Generator().manual_seed(0)).numpy(), [1, 0])


def test_decode_steps_counted_and_default_length():
    steps = []

    class Rec(GeneratorHook):
        def after_decode(self, *, decode_steps, generated_ids):
            steps.append(decode_steps)

    _run(_ScriptedModel([[i] for i in range(1, 6)]), 5, ignore_eos=True, silent=True, gen_kw=dict(hooks=[Rec()]))
    assert steps == [4]
    gen = _gen(_ScriptedModel([[1]] * 6))
    gen.max_new_tokens = 3
    assert gen.generate_from_ids(np.zeros(1, np.int32), np.ones(1, np.int32), ignore_eos=True, silent=True).shape == (1,
                                                                                                                     3)


# -- deterministic mode -------------------------------------------------------


def test_is_deterministic_env(monkeypatch):
    monkeypatch.delenv("MOJO_DETERMINISTIC", raising=False)
    assert not is_deterministic() and not MojoRunTimeConfig().is_deterministic
    monkeypatch.setenv("MOJO_DETERMINISTIC", "1")
    assert is_deterministic() and MojoRunTimeConfig().is_deterministic


@pytest.fixture
def restore_torch_flags(monkeypatch):
    saved = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark, torch.get_float32_matmul_precision())
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    yield
    torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = saved[2:6]
    torch.set_float32_matmul_precision(saved[6])


def test_enable_deterministic_sets_torch_flags(restore_torch_flags):
    torch.backends.cudnn.benchmark = True
    enable_deterministic()
    assert torch.are_deterministic_algorithms_enabled()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    assert torch.get_float32_matmul_precision() == "highest"


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in ("MOJO_DETERMINISTIC", "CUBLAS_WORKSPACE_CONFIG")}
    env.update(PYTHONPATH=str(REPO), MOJO_OPSET_PLUGIN_AUTOLOAD="0", **extra)
    return env


def test_env_var_applies_on_import():
    code = ("import os, torch, mojo_opset_tpu_torch\n"
            "print(torch.are_deterministic_algorithms_enabled(), os.environ.get('CUBLAS_WORKSPACE_CONFIG'),\n"
            "      torch.get_float32_matmul_precision(), torch.backends.cudnn.deterministic)\n")
    on = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                        env=_child_env(MOJO_DETERMINISTIC="1"))
    assert on.returncode == 0, on.stderr
    assert on.stdout.split() == ["True", ":4096:8", "highest", "True"]
    off = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, env=_child_env())
    assert off.returncode == 0, off.stderr
    assert off.stdout.split()[:2] == ["False", "None"]


@pytest.mark.parametrize("top_k", [1, 8, 64])
def test_deterministic_sampling_repeatable(restore_torch_flags, monkeypatch, top_k):
    """Ops that draw randomness take an explicit generator: under
    deterministic algorithms a seed gives the same draws, which equal the
    default mode's."""
    monkeypatch.setenv("MOJO_DETERMINISTIC", "1")
    logits = torch.randn(4, 64, generator=torch.Generator().manual_seed(3))
    want = MojoTopKSampling(top_k=top_k)(logits, torch.Generator().manual_seed(11))
    enable_deterministic()
    got = [MojoTopKSampling(top_k=top_k)(logits, torch.Generator().manual_seed(11)) for _ in range(2)]
    for probs, tokens in got:
        assert torch.equal(tokens, want[1]) and torch.equal(probs, want[0])


# -- checkpoints through the examples ----------------------------------------

os.environ.setdefault("USE_TF", "0")  # transformers skips importing TensorFlow (seconds)
transformers = pytest.importorskip("transformers")

QWEN3 = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
             head_dim=16, vocab_size=300, max_position_embeddings=256, tie_word_embeddings=True)
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny transformers Qwen3 (a vocabulary wide enough for the byte
    fallback tokenizer) and a word-level tokenizer, saved as HF saves them."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    torch.manual_seed(0)
    hf_model = transformers.Qwen3ForCausalLM(transformers.Qwen3Config(**QWEN3)).eval()
    path = tmp_path_factory.mktemp("qwen3_tiny_ckpt")
    hf_model.save_pretrained(path, safe_serialization=True)
    words = ["<eos>", "the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog"]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<eos>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="<eos>")
    tok_path = tmp_path_factory.mktemp("word_tokenizer")
    fast.save_pretrained(tok_path)
    return hf_model, str(path), str(tok_path)


def _hf_greedy(hf_model, ids, steps):
    ids = list(ids)
    for _ in range(steps):
        with torch.no_grad():
            ids.append(int(hf_model(input_ids=torch.tensor([ids])).logits[0, -1].argmax()))
    return ids[-steps:]


@pytest.mark.parametrize("fused", [False, True], ids=["stepwise", "fused"])
def test_llm_inference_serves_a_checkpoint(checkpoint, capsys, fused):
    hf_model, path, _ = checkpoint
    argv = ["--checkpoint", path, *CPU, "--greedy", "--max-new-tokens", "5", "--prompt", "Hi there",
            *(["--fused"] if fused else [])]
    result = llm_inference.main(argv)
    prompt = llm_inference._FallbackTokenizer()("Hi there").input_ids[0]
    want = _hf_greedy(hf_model, prompt, 5)
    eos = want.index(0) + 1 if 0 in want else 5  # the fallback tokenizer's EOS masks the rest
    assert result["ids"][0].tolist()[:eos] == want[:eos]
    assert "Prompt: Hi there" in capsys.readouterr().out


def test_llm_inference_tokenizer_and_int8_modes(checkpoint):
    hf_model, path, tok_path = checkpoint
    result = llm_inference.main(["--checkpoint", path, "--tokenizer", tok_path, *CPU, "--greedy",
                                 "--max-new-tokens", "4", "--prompt", "the quick brown fox"])
    want = _hf_greedy(hf_model, [1, 2, 3, 4], 4)
    eos = want.index(0) + 1 if 0 in want else 4
    assert result["ids"][0].tolist()[:eos] == want[:eos]
    assert isinstance(result["decoded"], str)
    for flags in (["--quant", "w8a8", "--quant-kv"], ["--speculative", "2"]):
        quant = llm_inference.main(["--checkpoint", path, *CPU, "--greedy", "--max-new-tokens", "4", *flags])
        assert quant["ids"].shape == (1, 4) and ((quant["ids"] >= 0) & (quant["ids"] < 300)).all()


def test_llm_inference_checkpoint_needs_every_weight(checkpoint, tmp_path):
    from safetensors.torch import load_file, save_file

    _, path, _ = checkpoint
    for name in ("config.json",):
        (tmp_path / name).write_bytes((Path(path) / name).read_bytes())
    state = load_file(str(Path(path) / "model.safetensors"))
    state.pop("model.norm.weight")
    save_file(state, str(tmp_path / "model.safetensors"))
    with pytest.raises(KeyError, match=r"model\.norm\.weight"):
        llm_inference.main(["--checkpoint", str(tmp_path), *CPU, "--greedy", "--max-new-tokens", "2"])


def test_dit_inference_loads_a_checkpoint(tmp_path):
    from safetensors.torch import save_file

    argv = [*CPU, "--steps", "1", "--dim", "64", "--layers", "1"]
    random = dit_inference.main(argv)
    cfg = WanConfig(patch_size=(1, 2, 2), text_len=64, in_dim=16, dim=64, ffn_dim=256, freq_dim=256, text_dim=512,
                    out_dim=16, num_heads=1, num_layers=1)
    source = WanModel(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    official = {wan_dit_rename_hook(k) or k: v.contiguous() for k, v in source.state_dict().items() if k != "freqs"}
    save_file(official, str(tmp_path / "model.safetensors"))
    loaded = dit_inference.main([*argv, "--ckpt-dir", str(tmp_path)])
    assert torch.equal(loaded["latent"], random["latent"])  # the example's own seed-0 weights, through the file
    save_file({k: v for k, v in official.items() if k != "head.head.weight"}, str(tmp_path / "model.safetensors"))
    with pytest.raises(KeyError, match=r"head\.head\.weight"):
        dit_inference.main([*argv, "--ckpt-dir", str(tmp_path)])


def test_qwen3_patch_tiny_selftest_verifies():
    result = qwen3_patch.main(["--tiny-selftest", "--verify", *CPU, "--max-new-tokens", "4"])
    assert result["ids"].shape[0] == 1 and 1 <= result["ids"].shape[1] <= 4
    assert result["max_abs_err"] < qwen3_patch.VERIFY_MAX_ABS
    hf_model = transformers.AutoModelForCausalLM.from_pretrained(result["path"], local_files_only=True).eval()
    prompt = (np.frombuffer("请用中文简要介绍 Qwen3 的主要能力。".encode(), np.uint8).astype(np.int64) % 127) + 1
    want = _hf_greedy(hf_model, prompt.tolist(), 4)
    eos = want.index(0) + 1 if 0 in want else 4
    assert result["ids"][0].tolist() == want[:eos]


def test_deterministic_checkpoint_serves_repeat_bit_for_bit(checkpoint, tmp_path):
    """The CPU form of chip_smoke.py phase 21's child: under
    MOJO_DETERMINISTIC=1 a checkpoint loads and serves twice, the tokens
    and every step's logits bit for bit."""
    _, path, _ = checkpoint
    code = f"""
import numpy as np, torch
from mojo_opset_tpu_torch.examples.llm_inference import _FallbackTokenizer
from mojo_opset_tpu_torch.runtime import GeneratorHook, GreedySampler, MojoGenerator, PagedAttentionGenerationModel
from mojo_opset_tpu_torch.utils.patching import apply_mojo_to_qwen3
assert torch.are_deterministic_algorithms_enabled()
model = apply_mojo_to_qwen3({path!r}, device="cpu", strict=True)

class Keep(GeneratorHook):
    def __init__(self):
        self.logits = []
    def after_prefill(self, *, logits, session):
        self.logits.append(logits.clone())
    def after_decode_step(self, *, step, logits, next_token_id):
        self.logits.append(logits.clone())

runs = []
for fused in (False, False, True):
    keep = Keep()
    gen = MojoGenerator(PagedAttentionGenerationModel(model, block_size=16), _FallbackTokenizer(), GreedySampler(),
                        max_new_tokens=6, hooks=[keep])
    runs.append((gen(["Hi", "a longer prompt"], ignore_eos=True, fused_decode=fused), keep.logits))
(a, la), (b, lb), (c, _) = runs
assert np.array_equal(a, b) and np.array_equal(a, c)
assert len(la) == len(lb) == 6 and all(torch.equal(x, y) for x, y in zip(la, lb))
print("deterministic ok", a.tolist())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env=_child_env(MOJO_DETERMINISTIC="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "deterministic ok" in out.stdout
