"""The port's HF glue on the CPU: the safetensors reader, the loading
pipeline, the config converters, the Wan2.2 renames, ``MojoDynamicConfig``
and the runtime namespace, each against the JAX package's counterpart
(its utils/hf.py, utils/patching.py, runtime/config.py) or against the
``safetensors`` library.

Tolerances, and why: the reader equals ``safetensors.torch.load_file`` bit
for bit. A model loaded by the port gives the JAX-loaded model's logits
within atol = rtol = 1e-4 (one fp32 algorithm, sums in another order;
BASELINE.md's fp32 limit is 6e-3) and holds exactly the checkpoint's
values. The Wan DiT and VAE loaded from official-named state dicts hold to
JAX's at the relative limits of tests/test_torch_wan.py (1e-5) and
tests/test_torch_wan_vae.py (6e-6).
"""

import json
import os
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as save_numpy
from safetensors.torch import load_file, save_file

from mojo_opset_tpu.modeling.qwen3 import Qwen3ForCausalLM as JaxQwen3
from mojo_opset_tpu.modeling.wan2_2 import WanConfig as JaxWanConfig
from mojo_opset_tpu.modeling.wan2_2 import WanModel as JaxWanModel
from mojo_opset_tpu.modeling.wan2_2 import modeling_vae as jax_vae
from mojo_opset_tpu.runtime import PagedAttentionGenerationModel as JaxPaged
from mojo_opset_tpu.runtime import config as jax_config
from mojo_opset_tpu.utils import hf as jax_hf
from mojo_opset_tpu.utils import patching as jax_patching
from mojo_opset_tpu_torch import runtime
from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3ForCausalLM, quantize_qwen3
from mojo_opset_tpu_torch.modeling.wan2_2 import WanConfig, WanModel, WanVAE_
from mojo_opset_tpu_torch.runtime import PagedAttentionGenerationModel
from mojo_opset_tpu_torch.runtime.config import MojoModelConfig
from mojo_opset_tpu_torch.utils import hf, patching
from mojo_opset_tpu_torch.utils.acc import check_tol_diff
from mojo_opset_tpu_torch.utils.weights import random_numpy_state

# JAX's tests/base/test_hf_loading.py config
TINY_HF_CFG = dict(hidden_size=32, intermediate_size=64, num_attention_heads=4, num_key_value_heads=2,
                   num_hidden_layers=2, head_dim=8, vocab_size=64, max_position_embeddings=64, rms_norm_eps=1e-6,
                   rope_theta=10000.0)
F32 = dict(atol=1e-4, rtol=1e-4)


def _tensors(seed=0):
    """Every dtype the reader takes, with 0-d and empty tensors."""
    g = torch.Generator().manual_seed(seed)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
        "i8": torch.randint(-128, 128, (9,), generator=g, dtype=torch.int8),
        "u8": torch.randint(0, 256, (5, 3), generator=g, dtype=torch.uint8),
        "i16": torch.randint(-30000, 30000, (6,), generator=g, dtype=torch.int16),
        "i32": torch.randint(-2**31, 2**31 - 1, (4, 2), generator=g, dtype=torch.int32),
        "i64": torch.randint(-2**62, 2**62, (3,), generator=g, dtype=torch.int64),
        "bool": torch.rand(11, generator=g) > 0.5,
        "scalar_f32": torch.tensor(3.25),
        "scalar_bf16": torch.tensor(-1.5, dtype=torch.bfloat16),
        "scalar_i64": torch.tensor(7, dtype=torch.int64),
        "empty_f32": torch.empty(0, 4),
        "empty_bf16": torch.empty(2, 0, dtype=torch.bfloat16),
    }


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _write(path, layout, tensors, metadata=None):
    """``tensors`` as one ``model.safetensors`` or as two shards with an index."""
    os.makedirs(path, exist_ok=True)
    if layout == "single":
        save_file(tensors, os.path.join(path, "model.safetensors"), metadata=metadata)
        return
    keys = sorted(tensors)
    shards = {"model-00001-of-00002.safetensors": keys[::2], "model-00002-of-00002.safetensors": keys[1::2]}
    for name, ks in shards.items():
        save_file({k: tensors[k] for k in ks}, os.path.join(path, name), metadata=metadata)
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": {k: n for n, ks in shards.items() for k in ks}}, f)


@pytest.mark.parametrize("layout", ["single", "index"])
def test_reader_matches_safetensors_bit_for_bit(tmp_path, layout):
    tensors = _tensors()
    _write(tmp_path, layout, tensors, metadata={"format": "pt"})
    want = {}
    for name in os.listdir(tmp_path):
        if name.endswith(".safetensors"):
            want.update(load_file(os.path.join(tmp_path, name)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # torch.frombuffer warns on a read-only buffer
        got = hf.load_sharded_safetensors(str(tmp_path))
    assert set(got) == set(want) == set(tensors)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape and g.device.type == "cpu", key
        assert _bits(g) == _bits(w) == _bits(tensors[key]), key


def test_reader_maps_the_file_copy_on_write(tmp_path):
    """The tensors view the file (no host copy in another dtype), outlive
    the dict that held them, and a write to one never reaches the file."""
    _write(tmp_path, "single", _tensors())
    got = hf.read_safetensors(str(tmp_path / "model.safetensors"))
    bf16 = got.pop("bf16")
    del got
    assert bf16.dtype == torch.bfloat16
    before = bf16.clone()
    bf16.fill_(0)
    again = hf.read_safetensors(str(tmp_path / "model.safetensors"))["bf16"]
    assert torch.equal(again, before) and not torch.equal(again, bf16)


@pytest.mark.parametrize("dtype,name", [(torch.float8_e4m3fn, "F8_E4M3"), (torch.float64, "F64")])
def test_reader_refuses_other_dtypes(tmp_path, dtype, name):
    save_file({"ok": torch.ones(2), "model.layers.0.mlp.down_proj.weight": torch.ones(2, 2).to(dtype)},
              str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match=rf"model\.layers\.0\.mlp\.down_proj\.weight.*{name}"):
        hf.load_sharded_safetensors(str(tmp_path))


def test_missing_checkpoint_raises(tmp_path):
    for load in (hf.load_sharded_safetensors, jax_hf.load_sharded_safetensors):
        with pytest.raises(FileNotFoundError):
            load(str(tmp_path))


def _fp32_translate(translate):
    def fn(cfg_dict):
        c = translate(cfg_dict)
        c.dtype = jnp.float32 if translate is jax_hf.qwen3_config_from_hf else torch.float32
        return c

    return fn


@pytest.fixture(scope="module")
def sharded_checkpoint(tmp_path_factory):
    """JAX's test_build_model_from_sharded_safetensors checkpoint: a JAX
    model's ``state_dict_of`` in two shards, the index and config.json."""
    path = tmp_path_factory.mktemp("two_shards")
    cfg = jax_hf.qwen3_config_from_hf(TINY_HF_CFG)
    cfg.dtype = jnp.float32
    source = JaxQwen3(cfg, key=jax.random.PRNGKey(7))
    sd = {k: v for k, v in jax_hf.state_dict_of(source).items() if not k.endswith("inv_freq")}
    keys = sorted(sd)
    half = len(keys) // 2
    shards = {"model-00001.safetensors": {k: sd[k] for k in keys[:half]},
              "model-00002.safetensors": {k: sd[k] for k in keys[half:]}}
    for name, kv in shards.items():
        save_numpy(kv, str(path / name))
    with open(path / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": {k: s for s, kv in shards.items() for k in kv}}, f)
    with open(path / "config.json", "w") as f:
        json.dump(TINY_HF_CFG, f)
    return str(path), source, sd


def test_build_model_from_sharded_safetensors_matches_jax(sharded_checkpoint):
    path, source, sd = sharded_checkpoint
    jax_loaded = jax_hf.build_model_from_hf(JaxQwen3, path, config_translate=_fp32_translate(jax_hf.qwen3_config_from_hf),
                                            key=jax.random.PRNGKey(0))
    port = hf.build_model_from_hf(Qwen3ForCausalLM, path, config_translate=_fp32_translate(hf.qwen3_config_from_hf),
                                  device="cpu", generator=torch.Generator().manual_seed(0))
    state = port.state_dict()
    assert set(state) == set(sd)
    for key, want in sd.items():
        assert np.array_equal(state[key].numpy(), want), key
    ids, lens = np.array([1, 2, 3, 9, 4], np.int32), np.array([3, 2], np.int32)
    want, _ = JaxPaged(jax_loaded, block_size=16, jit=False)(ids, context_input_len=lens)
    source_logits, _ = JaxPaged(source, block_size=16, jit=False)(ids, context_input_len=lens)
    got, _ = PagedAttentionGenerationModel(port, block_size=16)(ids, context_input_len=lens)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(source_logits))
    check_tol_diff(got, np.asarray(want), **F32)


def _port_model(seed=0):
    cfg = hf.qwen3_config_from_hf(TINY_HF_CFG)
    cfg.dtype = torch.float32
    return Qwen3ForCausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


def _jax_model(seed=0):
    cfg = jax_hf.qwen3_config_from_hf(TINY_HF_CFG)
    cfg.dtype = jnp.float32
    return JaxQwen3(cfg, key=jax.random.PRNGKey(seed))


def test_missing_keys_strict_and_not(sharded_checkpoint, monkeypatch):
    _, _, sd = sharded_checkpoint
    weights = {k: torch.tensor(v) for k, v in sd.items() if k != "model.norm.weight"}
    with pytest.raises(KeyError, match=r"model\.norm\.weight"):
        hf.load_state_dict(_port_model(), weights)
    with pytest.raises(KeyError, match=r"model\.norm\.weight"):
        jax_hf.load_state_dict(_jax_model(), {k: v for k, v in sd.items() if k != "model.norm.weight"})
    warned = []
    monkeypatch.setattr(hf.logger, "warning", lambda msg, *a: warned.append(msg % a))
    model = _port_model()
    init = model.model.norm.weight.clone()
    hf.load_state_dict(model, weights, strict=False)
    assert warned == ["load_state_dict: 1 params kept their init values"]
    assert torch.equal(model.model.norm.weight, init)
    assert np.array_equal(model.lm_head.weight.numpy(), sd["lm_head.weight"])
    # build_model_from_hf is not strict by default, as in the JAX package
    assert hf.build_model_from_hf.__defaults__ == jax_hf.build_model_from_hf.__defaults__ == (None, None, None,
                                                                                               False, None)


def test_shape_mismatch_raises(sharded_checkpoint):
    _, _, sd = sharded_checkpoint
    bad = dict(sd, **{"model.norm.weight": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match=r"shape mismatch for model\.norm\.weight"):
        hf.load_state_dict(_port_model(), {k: torch.tensor(v) for k, v in bad.items()})
    with pytest.raises(ValueError, match=r"shape mismatch for model\.norm\.weight"):
        jax_hf.load_state_dict(_jax_model(), bad)


def test_rename_hooks_first_non_none_wins(sharded_checkpoint):
    """A hook returning None passes to the next; the first key wins even
    where a later hook would have found the tensor; no key: the name."""
    _, _, sd = sharded_checkpoint
    prefixed = {("ckpt." + k if "layers" in k else k): v for k, v in sd.items()}
    hooks = [lambda p: None, lambda p: "ckpt." + p if ".layers." in p else None, lambda p: "nowhere." + p]
    model = hf.load_state_dict(_port_model(), {k: torch.tensor(v) for k, v in prefixed.items()},
                               rename_hooks=hooks[:2])
    jax_model = jax_hf.load_state_dict(_jax_model(), prefixed, rename_hooks=hooks[:2])
    state, jax_state = model.state_dict(), jax_hf.state_dict_of(jax_model)
    for key, want in sd.items():
        assert np.array_equal(state[key].numpy(), want) and np.array_equal(jax_state[key], want), key
    with pytest.raises(KeyError, match=r"model\.embed_tokens\.weight"):  # the last hook shadows the name
        hf.load_state_dict(_port_model(), {k: torch.tensor(v) for k, v in sd.items()}, rename_hooks=hooks[2:])
    with pytest.raises(KeyError, match=r"model\.embed_tokens\.weight"):
        jax_hf.load_state_dict(_jax_model(), sd, rename_hooks=hooks[2:])


@pytest.mark.parametrize("pattern,applied", [(r"model\.norm\.weight", True), (r"model\.norm", False),
                                             (r"norm\.weight", False), (r"model\.layers\.\d+\.input_layernorm\.weight",
                                                                         False)])
def test_converters_match_the_whole_name(sharded_checkpoint, pattern, applied):
    _, _, sd = sharded_checkpoint
    model = hf.load_state_dict(_port_model(), {k: torch.tensor(v) for k, v in sd.items()},
                               converters={pattern: lambda w: 2 * w})
    jax_model = jax_hf.load_state_dict(_jax_model(), sd, converters={pattern: lambda w: 2 * w})
    want = sd["model.norm.weight"] * (2 if applied else 1)
    assert np.array_equal(model.model.norm.weight.numpy(), want)
    assert np.array_equal(np.asarray(jax_model.model.norm.weight), want)


def test_integer_parameters_take_only_their_dtype():
    model = quantize_qwen3(_port_model())
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    hf.load_state_dict(model, weights)  # the int8 weights as they are
    weights["model.layers.0.mlp.down_proj.weight"] = weights["model.layers.0.mlp.down_proj.weight"].float()
    with pytest.raises(ValueError, match=r"model\.layers\.0\.mlp\.down_proj\.weight"):
        hf.load_state_dict(model, weights)


def test_numpy_state_of_a_bf16_jax_model_loads():
    """The JAX package's state dicts hold numpy arrays, bf16 ones in
    ml_dtypes' bfloat16, which torch.from_numpy does not take."""
    sd = {k: v for k, v in jax_hf.state_dict_of(JaxQwen3(jax_hf.qwen3_config_from_hf(TINY_HF_CFG),
                                                          key=jax.random.PRNGKey(2))).items()
          if not k.endswith("inv_freq")}
    assert sd["model.embed_tokens.weight"].dtype.name == "bfloat16"
    model = hf.load_state_dict(Qwen3ForCausalLM(hf.qwen3_config_from_hf(TINY_HF_CFG), device="cpu"), sd)
    for key, value in model.state_dict().items():
        assert np.array_equal(value.float().numpy(), np.asarray(sd[key], np.float32)), key
    assert model.model.embed_tokens.weight.dtype == torch.bfloat16


def test_ignored_suffixes_cover_both_packages():
    assert set(jax_hf.IGNORED_SUFFIXES) <= set(hf.IGNORED_SUFFIXES)
    assert {"freqs", "codebook"} <= set(hf.IGNORED_SUFFIXES)


CONVERTER_DICTS = [
    {},
    dict(TINY_HF_CFG, torch_dtype="float32", tie_word_embeddings=True, attention_bias=True),
    dict(hidden_size=64, num_attention_heads=8, dtype="float16", num_experts=4, num_experts_per_tok=2,
         moe_intermediate_size=32, rope_theta=1e6, attention_out_bias=True, mlp_bias=True, q_lora_rank=None,
         kv_lora_rank=16, qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16, n_routed_experts=4,
         first_k_dense_replace=1),
]


@pytest.mark.parametrize("name", ["qwen3_config_from_hf", "seed_oss_config_from_hf", "qwen3_moe_config_from_hf",
                                  "deepseek_v3_config_from_hf"])
@pytest.mark.parametrize("which", range(len(CONVERTER_DICTS)))
def test_config_converters_match_jax(name, which):
    cfg = CONVERTER_DICTS[which]
    got, want = getattr(hf, name)(cfg), getattr(jax_hf, name)(cfg)
    jax_fields = {f: getattr(want, f) for f in want.__dataclass_fields__}
    for field, value in jax_fields.items():
        if field == "dtype":
            assert str(getattr(got, field)).split(".")[-1] == jnp.dtype(value).name
        elif hasattr(got, field):
            assert getattr(got, field) == value, field
    assert {"quant"} >= set(got.__dataclass_fields__) - set(jax_fields) - {"kv_layout", "quant_kv"}


def test_dtype_from_hf_defaults_to_bf16():
    for name, want in (("float32", torch.float32), ("float16", torch.float16), ("bfloat16", torch.bfloat16),
                       (None, torch.bfloat16), ("float64", torch.bfloat16)):
        assert hf._dtype_from_hf(name) == want
        assert jnp.dtype(jax_hf._dtype_from_hf(name)).name == str(want).split(".")[-1]


def test_stack_hf_moe_experts_matches_jax():
    rng = np.random.default_rng(0)
    E, H, I = 3, 8, 4
    sd = {"model.layers.0.mlp.gate.weight": rng.standard_normal((E, H)).astype(np.float32),
          "model.embed_tokens.weight": rng.standard_normal((5, H)).astype(np.float32)}
    for e in range(E):
        for proj, shape in (("gate_proj", (I, H)), ("up_proj", (I, H)), ("down_proj", (H, I))):
            sd[f"model.layers.0.mlp.experts.{e}.{proj}.weight"] = rng.standard_normal(shape).astype(np.float32)
    want = jax_hf.stack_hf_moe_experts(sd, E)
    got = hf.stack_hf_moe_experts({k: torch.tensor(v) for k, v in sd.items()}, E)
    assert set(got) == set(want) == {"model.embed_tokens.weight", "model.layers.0.mlp.experts.up_proj_weight",
                                     "model.layers.0.mlp.experts.down_proj_weight",
                                     "model.layers.0.mlp.gating.gate_weight"}
    for key in want:
        assert np.array_equal(got[key].numpy(), want[key]), key


def test_deepseek_interleave_converters_match_jax():
    cfg = dict(qk_nope_head_dim=16, qk_rope_head_dim=8, kv_lora_rank=16)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((4 * 24, 32)).astype(np.float32)
    kv_a = rng.standard_normal((16 + 8, 64)).astype(np.float32)
    got, want = hf.deepseek_v3_interleave_converters(cfg), jax_hf.deepseek_v3_interleave_converters(cfg)
    assert list(got) == list(want)
    for pattern, w in zip(want, (q, kv_a)):
        assert np.array_equal(got[pattern](torch.from_numpy(w)).numpy(), want[pattern](w))
    assert np.array_equal(hf._deinterleave_rows(torch.from_numpy(kv_a)).numpy(), jax_hf._deinterleave_rows(kv_a))


# -- Wan2.2: official-named state dicts -------------------------------------

WAN_TINY = dict(patch_size=(1, 2, 2), text_len=8, in_dim=4, dim=32, ffn_dim=64, freq_dim=16, text_dim=24, out_dim=4,
                num_heads=2, num_layers=2)
# a small VAE with the published stage layout and temporal stride (tests/test_torch_wan_vae.py)
VAE_TINY = dict(dim=8, dec_dim=8, z_dim=4, temperal_downsample=(False, True, True))


def test_wan_dit_loads_official_names_as_jax():
    source = JaxWanModel(JaxWanConfig(model_type="ti2v", **WAN_TINY), key=jax.random.PRNGKey(3))
    sd = {k: v for k, v in jax_hf.state_dict_of(source).items() if k != "freqs"}
    official = {patching.wan_dit_rename_hook(k) or k: v for k, v in sd.items()}
    assert official.keys() != sd.keys() and "text_embedding.0.weight" in official and "blocks.1.ffn.2.bias" in official
    assert all(patching.wan_dit_rename_hook(k) == jax_patching.wan_dit_rename_hook(k) for k in sd)
    jax_model = jax_patching.apply_mojo_to_wan2_2(official, config=JaxWanConfig(model_type="ti2v", **WAN_TINY),
                                                  key=jax.random.PRNGKey(0))
    model = patching.apply_mojo_to_wan2_2(official, config=WanConfig(model_type="ti2v", **WAN_TINY), device="cpu",
                                          strict=True)
    assert isinstance(model, WanModel)
    state = model.state_dict()
    for key, want in sd.items():
        assert np.array_equal(state[key].numpy(), want), key
    rng = np.random.default_rng(4)
    x = [rng.standard_normal((4, 2, 8, 8)).astype(np.float32)]
    ctx = [rng.standard_normal((6, 24)).astype(np.float32)]
    t = np.array([500.0], np.float32)
    want = jax_model([jnp.asarray(x[0])], jnp.asarray(t), [jnp.asarray(ctx[0])], seq_len=32)[0]
    with torch.inference_mode():
        got = model([torch.from_numpy(x[0])], torch.from_numpy(t), [torch.from_numpy(ctx[0])], seq_len=32)[0]
    check_tol_diff(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def _official_vae_state(sd):
    """JAX's VAE state under the official names: ``<last>`` resolved to the
    stage's block count, the RMS norms' weights named ``gamma``."""
    blocks = {}
    for k in sd:
        m = re.fullmatch(r"(encoder\.downsamples|decoder\.upsamples)\.(\d+)\.blocks\.(\d+)\..+", k)
        if m:
            seq = "downsamples" if m.group(1).startswith("encoder") else "upsamples"
            prefix = f"{m.group(1)}.{m.group(2)}.{seq}"
            blocks[prefix] = max(blocks.get(prefix, 0), int(m.group(3)) + 1)
    official = {}
    for k, v in sd.items():
        key = jax_patching.wan_vae_rename_hook(k) or k
        if ".<last>." in key:
            prefix = key.split(".<last>.")[0]
            key = key.replace("<last>", str(blocks[prefix]))
        if "norm" in k and key.endswith(".weight"):
            key = key[: -len(".weight")] + ".gamma"
        official[key] = v
    return official


def test_wan_vae_loads_official_names_as_jax():
    jax_source = jax_vae.WanVAE_(**VAE_TINY)
    weights = random_numpy_state(WanVAE_(**VAE_TINY, device="meta"), 5)
    jax_source = jax_hf.load_state_dict(jax_source, weights)
    sd = jax_hf.state_dict_of(jax_source)
    official = _official_vae_state(sd)
    assert any(k.endswith(".gamma") for k in official)
    assert any(re.search(r"\.downsamples\.2\.resample\.1\.weight$", k) for k in official)  # <last> resolved
    assert all(patching.wan_vae_rename_hook(k) == jax_patching.wan_vae_rename_hook(k) for k in sd)
    jax_model = jax_patching.apply_mojo_to_wan2_2_vae(official, key=jax.random.PRNGKey(0), **VAE_TINY)
    model = patching.apply_mojo_to_wan2_2_vae(official, device="cpu", strict=True, **VAE_TINY)
    state = model.state_dict()
    for key, want in sd.items():
        assert np.array_equal(state[key].numpy(), want), key
    x = np.random.default_rng(6).standard_normal((1, 3, 5, 16, 16)).astype(np.float32)
    want_mu = np.asarray(jax.jit(jax_model.encode)(jnp.asarray(x)))
    want_video = np.asarray(jax.jit(jax_model.decode)(jnp.asarray(want_mu)))
    with torch.inference_mode():
        mu = model.encode(torch.tensor(x))
        video = model.decode(torch.tensor(want_mu))
    for got, want in ((mu, want_mu), (video, want_video)):
        g, w = got.double().numpy(), np.asarray(want, np.float64)
        assert g.shape == w.shape and np.linalg.norm(g - w) / np.linalg.norm(w) < 6e-6


# -- MojoDynamicConfig and the runtime namespace -----------------------------

DYNAMIC_DICTS = [
    {"hidden_size": 64, "num_heads": 4, "dtype": "float32", "my_flag": True, "rope_scaling": {"type": "yarn"}},
    {"vocab_size": 10, "model_name": "x", "extra": {"a": 1}},
    {"dtype": "bfloat16", "tie_word_embeddings": True, "unknown": [1, 2]},
]


@pytest.mark.parametrize("values", DYNAMIC_DICTS)
def test_dynamic_config_from_dict_matches_jax(values):
    got = MojoModelConfig.from_dict(values)
    want = jax_config.MojoModelConfig.from_dict(values)
    assert isinstance(got, runtime.MojoDynamicConfig)
    assert got.extra_fields() == want.extra_fields()
    for key, value in values.items():
        if key == "dtype":
            assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name == value
        else:
            assert getattr(got, key) == getattr(want, key) == value
    with pytest.raises(ValueError, match="unsupported dtype"):
        MojoModelConfig.from_dict({"dtype": "int3"})


def test_runtime_namespace_exports_what_jax_exports_and_the_port_has():
    names = ("MojoSession", "MojoDynamicConfig", "MojoComputeCommContext", "MojoSymmetricMemoryManager",
             "dp_allreduce", "dp_gather", "dp_scatter", "merge_group_and_share_ffn")
    import mojo_opset_tpu.runtime as jax_runtime

    for name in names:
        assert hasattr(jax_runtime, name) and hasattr(runtime, name) and name in runtime.__all__, name
    assert runtime.MojoComputeCommContext.__module__ == "mojo_opset_tpu_torch.runtime.comm_context"
    assert runtime.dp_gather.__module__ == "mojo_opset_tpu_torch.runtime.parallel"
