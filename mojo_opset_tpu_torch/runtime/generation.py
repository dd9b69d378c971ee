"""Generation loop: tokenize -> prefill -> sample -> decode, with hooks.

Counterpart of the JAX package's ``runtime/generation.py`` (``MojoSession``
:33, ``MojoSampler`` :39, ``GreedySampler`` :44, ``TopKSampler`` :49,
``GeneratorHook`` :60, ``PerfHook`` :68, ``DumpHook`` :145,
``_Typewriter`` :165, ``MojoGenerator`` :199, ``PerfMojoGenerator`` :353).
``MojoGenerator.__call__`` tokenizes prompts, packs
them varlen and generates. The sampler runs on the device; the stepwise
loop reads each step's tokens back for EOS handling, the fused loop
(``FusedDecode``) only at the end. The typewriter
(``enable_typewriter=True``) decodes text on a daemon thread from those
same host copies, every ``typewriter_buffer`` steps, so it adds no device
read to the loop. Randomness comes from one
``torch.Generator`` that the generator holds on the model's device, where
the JAX package splits a key chain. With the model's decode graphs on
(``PagedAttentionGenerationModel.device_graph``) the generator keeps one
session per batch size and one ``FusedDecode`` per sampler, renewing the
session each call, so a call's decode steps and window replay the graphs
of the calls before it (a graph holds its session's cache addresses).
The loop's spans (``utils.tracing.span``, recorded only while tracing is
on): ``mojo.generate`` a call, ``mojo.prefill`` the model's prefill call,
``mojo.decode_step`` a stepwise iteration's whole body,
``mojo.decode_window`` a fused window, ``mojo.sample`` each sampler call,
``mojo.host_sync`` each read of tokens to the host, ``mojo.hooks`` each
run of the hooks.
``PerfMojoGenerator`` is the end-to-end protocol: prefill ms at seqlens
512-8192 (bs 1) and decode tok/s at bs 1-24 (ctx 4000), each case run once
warm and once recorded, and optionally whole ``FusedDecode`` windows, timed
with CUDA events on the card.
"""

from __future__ import annotations

import queue
import threading
import time
from abc import ABC, abstractmethod
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from mojo_opset_tpu_torch.benchmark.timing import chain_seconds
from mojo_opset_tpu_torch.core.operators.sampling import MojoTopKSampling
from mojo_opset_tpu_torch.runtime.session import FusedDecode
from mojo_opset_tpu_torch.utils.logging import get_logger, log_table
from mojo_opset_tpu_torch.utils.tracing import span

logger = get_logger(__name__)


class MojoSession(ABC):
    @property
    @abstractmethod
    def kv_cache(self): ...


class MojoSampler(ABC):
    @abstractmethod
    def __call__(self, logits: torch.Tensor, session=None, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor: ...


class GreedySampler(MojoSampler):
    def __call__(self, logits: torch.Tensor, session=None, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        return torch.argmax(logits, dim=-1).to(torch.int32)


class TopKSampler(MojoSampler):
    def __init__(self, top_k: int = 50):
        self.op = MojoTopKSampling(top_k=top_k)

    def __call__(self, logits: torch.Tensor, session=None, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        _, tokens = self.op(logits, generator)
        return tokens[..., 0].to(torch.int32)


class GeneratorHook:
    def before_prefill(self, *, input_ids, context_input_len): ...
    def after_prefill(self, *, logits, session): ...
    def before_decode(self): ...
    def after_decode_step(self, *, step, logits, next_token_id): ...
    def after_decode(self, *, decode_steps, generated_ids): ...


class PerfHook(GeneratorHook):
    """Wall-clock phase timer for the generate loop.

    Each phase boundary stamps ``perf_counter``; a boundary that closes
    device work first synchronizes the device of the newest tensor it has
    seen (PyTorch returns before the device finishes). ``records`` holds
    one dict per generate call: batch_size / in_tok / prefill_ms /
    decode_steps / decode_total_ms / decode_avg_ms / throughput (tok/s
    across the batch).
    """

    def __init__(self, silent: bool = False):
        self.records: List[dict] = []
        self._silent = silent
        self._marks: dict = {}
        self._batch = 0
        self._in_tokens = 0
        self._tail = None  # newest device tensor seen during decode

    @staticmethod
    def _fence(x) -> None:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)

    def _stamp(self, name: str) -> None:
        self._marks[name] = time.perf_counter()

    def before_prefill(self, *, input_ids, context_input_len):
        lens = np.asarray(context_input_len)
        self._batch = int(lens.shape[0])
        self._in_tokens = int(lens.sum())
        self._stamp("prefill")

    def after_prefill(self, *, logits, session):
        self._fence(logits)
        self._stamp("prefill_done")

    def before_decode(self):
        self._stamp("decode")

    def after_decode_step(self, *, step, logits, next_token_id):
        self._tail = next_token_id

    def after_decode(self, *, decode_steps, generated_ids):
        self._fence(self._tail)
        self._stamp("decode_done")
        m = self._marks
        total_ms = (m["decode_done"] - m["decode"]) * 1e3
        per_step = total_ms / decode_steps if decode_steps else 0.0
        rec = {
            "batch_size": self._batch,
            "in_tok": self._in_tokens,
            "prefill_ms": (m["prefill_done"] - m["prefill"]) * 1e3,
            "decode_steps": decode_steps,
            "decode_total_ms": total_ms,
            "decode_avg_ms": per_step,
            "throughput": self._batch * 1e3 / per_step if per_step else 0.0,
        }
        self.records.append(rec)
        if not self._silent:
            logger.info(
                "[Perf] bs=%(batch_size)d in_tok=%(in_tok)d | prefill=%(prefill_ms).1fms | "
                "decode=%(decode_steps)dsteps %(decode_total_ms).1fms avg=%(decode_avg_ms).1fms/step "
                "%(throughput).1ftok/s",
                rec,
            )


class DumpHook(GeneratorHook):
    """Writes each step's logits as ``.npy`` for offline diffing:
    ``prefill_logits.npy``, then ``decode_step_NNN_logits.npy`` for decode
    steps up to ``max_decode_steps``. bf16 logits are saved as fp32 (numpy
    has no bf16)."""

    def __init__(self, dump_dir: str, max_decode_steps: int = 20):
        self._dir = Path(dump_dir)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._budget = max_decode_steps

    def _save(self, stem: str, logits: torch.Tensor) -> None:
        host = logits.detach().cpu()
        np.save(self._dir / f"{stem}.npy", (host.float() if host.dtype == torch.bfloat16 else host).numpy())

    def after_prefill(self, *, logits, session):
        self._save("prefill_logits", logits)

    def after_decode_step(self, *, step, logits, next_token_id):
        if step <= self._budget:
            self._save(f"decode_step_{step:03d}_logits", logits)


class _Typewriter:
    """Streams decoded text from a daemon thread so the tokenizer's decode
    stays off the decode loop."""

    def __init__(self, tokenizer):
        self._tokenizer = tokenizer
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        full_output = None
        while True:
            item = self._q.get()
            if item is None:
                print("\nGeneration is done.")
                return
            ids = np.concatenate(item, axis=-1)
            texts = [self._tokenizer.decode(row) for row in ids]
            if full_output is None:
                full_output = [f"[{i}] {t}" for i, t in enumerate(texts)]
            else:
                full_output = [a + b for a, b in zip(full_output, texts)]
            print("\033[H\033[0J" + "\n".join(full_output), end="", flush=True)

    def send(self, generated_ids):
        """``generated_ids``: host arrays (B, n) of consecutive steps."""
        self._q.put([np.asarray(g) for g in generated_ids])

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=5)


class MojoGenerator:
    """Prefill + sampler + decode loop with EOS masking, a hook bus and an
    optional typewriter."""

    def __init__(
        self,
        model,
        tokenizer,
        sampler: MojoSampler,
        max_new_tokens: int = 128,
        enable_typewriter: bool = False,
        typewriter_buffer: int = 4,
        hooks: Optional[List[GeneratorHook]] = None,
        seed: int = 0,
    ):
        self.model = model
        self.tokenizer = tokenizer
        self.max_new_tokens = max_new_tokens
        self.sampler = sampler
        self._enable_typewriter = enable_typewriter
        self._typewriter_buffer = typewriter_buffer
        self._hooks = hooks or []
        device = next(model.model.parameters()).device
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self._session = None
        self._fused: dict = {}  # (sample method, top_k) -> FusedDecode
        self._calls = 0  # generate calls so far: the spans' ``call``

    def _session_for(self, context_input_len):
        """None (the model makes a new session) or, with decode graphs, the
        generator's session for this batch size, renewed."""
        if not getattr(self.model, "device_graph", False):
            return None
        batch_size = int(np.asarray(context_input_len).size)
        if self._session is None or self._session.batch_size != batch_size:
            self._session = self.model._new_session(None, context_input_len)
        self._session.renew()
        return self._session

    def _run_hooks(self, method: str, **kwargs):
        with span("mojo.hooks"):
            for hook in self._hooks:
                getattr(hook, method)(**kwargs)

    def _prefill(self, input_ids, context_input_len):
        session = self._session_for(context_input_len)
        with span("mojo.prefill"):
            return self.model(input_ids, context_input_len=context_input_len, session=session)

    def _sample(self, logits, session) -> torch.Tensor:
        with span("mojo.sample"):
            return self.sampler(logits, session, generator=self.generator)

    @staticmethod
    def _to_host(tokens: torch.Tensor) -> np.ndarray:
        """The tokens read back to the host: waits for the device."""
        with span("mojo.host_sync"):
            return tokens.cpu().numpy()

    def _eos_id(self) -> int:
        eos_id = getattr(self.tokenizer, "eos_token_id", -1)
        return -1 if eos_id is None else eos_id

    def __call__(self, prompts, **kwargs) -> np.ndarray:
        """Tokenize ``prompts`` (a string or a list of them), pack them
        varlen, print them and generate (``kwargs`` as
        ``generate_from_ids``)."""
        batch = [prompts] if isinstance(prompts, str) else prompts
        encoded = self.tokenizer(batch, return_tensors=None).input_ids
        context_input_len = np.asarray([len(seq) for seq in encoded], np.int32)
        input_ids = np.concatenate([np.asarray(seq, np.int32) for seq in encoded])
        print(f"Prompt: {prompts}")
        print("-" * 40)
        return self.generate_from_ids(input_ids, context_input_len, **kwargs)

    def generate_from_ids(
        self,
        input_ids,
        context_input_len,
        max_decode_steps: Optional[int] = None,
        ignore_eos: bool = False,
        silent: bool = False,
        fused_decode: bool = False,
    ) -> np.ndarray:
        """Returns the generated ids (B, steps) as numpy int32. ``silent``
        keeps the typewriter quiet."""
        if max_decode_steps is None:
            max_decode_steps = self.max_new_tokens
        self._calls += 1
        with span("mojo.generate", call=self._calls, batch=int(np.asarray(context_input_len).size),
                  prompt_tokens=int(np.asarray(context_input_len).sum())):
            if fused_decode:
                return self._generate_fused(input_ids, context_input_len, max_decode_steps, ignore_eos)
            return self._generate_stepwise(input_ids, context_input_len, max_decode_steps, ignore_eos, silent)

    def _generate_fused(self, input_ids, context_input_len, max_decode_steps, ignore_eos):
        """Decode window through ``FusedDecode`` (greedy, or top-k for any
        other sampler, as the JAX package decides); EOS masking on the host
        afterwards."""
        eos_id = self._eos_id()
        self._run_hooks("before_prefill", input_ids=input_ids, context_input_len=context_input_len)
        logits, session = self._prefill(input_ids, context_input_len)
        self._run_hooks("after_prefill", logits=logits, session=session)

        first = self._sample(logits, session)
        self._run_hooks("before_decode")
        method = "greedy" if isinstance(self.sampler, GreedySampler) else "topk"
        top_k = getattr(getattr(self.sampler, "op", None), "top_k", 50)
        if (method, top_k) not in self._fused:
            self._fused[method, top_k] = FusedDecode(self.model.model, sample_method=method, top_k=top_k,
                                                     device_graph=getattr(self.model, "device_graph", None))
        with span("mojo.decode_window", call=self._calls, steps=max_decode_steps - 1):
            toks = self._fused[method, top_k](session, first, max_decode_steps - 1, generator=self.generator)
        out = self._to_host(torch.cat([first[None], toks], dim=0).T)  # (B, steps)
        self._run_hooks("after_decode", decode_steps=max_decode_steps - 1, generated_ids=list(out.T))
        if not ignore_eos and eos_id >= 0:
            after = np.cumsum(out == eos_id, axis=1) > 0
            out = np.where(after, eos_id, out)
        return out

    def _generate_stepwise(self, input_ids, context_input_len, max_decode_steps, ignore_eos, silent=False):
        eos_id = self._eos_id()
        typewriter = _Typewriter(self.tokenizer) if (self._enable_typewriter and not silent) else None
        self._run_hooks("before_prefill", input_ids=input_ids, context_input_len=context_input_len)
        logits, session = self._prefill(input_ids, context_input_len)
        self._run_hooks("after_prefill", logits=logits, session=session)

        next_token_id = self._sample(logits, session)
        next_np = self._to_host(next_token_id)
        all_generated = [next_np]
        pending = [next_np]  # the typewriter's steps not sent yet
        should_end = next_np == eos_id
        decode_steps = 0

        self._run_hooks("before_decode")
        for step in range(1, max_decode_steps):
            with span("mojo.decode_step", call=self._calls, step=step):
                logits, session = self.model(next_token_id, session=session)
                next_token_id = self._sample(logits, session)
                decode_steps += 1
                self._run_hooks("after_decode_step", step=step, logits=logits, next_token_id=next_token_id)
                next_np = self._to_host(next_token_id)
                prev_end = should_end
                should_end = should_end | (next_np == eos_id)
                if not ignore_eos:
                    # sequences that ended earlier stay clamped to EOS; the step
                    # that produces a sequence's first EOS is still emitted
                    next_np = np.where(prev_end, eos_id, next_np).astype(np.int32)
                    next_token_id = torch.as_tensor(next_np, device=next_token_id.device)
                all_generated.append(next_np)
                pending.append(next_np)
                if not ignore_eos and bool(np.all(should_end)):
                    break
                if typewriter is not None and len(pending) >= self._typewriter_buffer:
                    typewriter.send([g[:, None] for g in pending])
                    pending = []

        self._run_hooks("after_decode", decode_steps=decode_steps, generated_ids=all_generated)
        if typewriter is not None:
            if pending:
                typewriter.send([g[:, None] for g in pending])
            typewriter.close()
        return np.stack(all_generated, axis=-1)


class PerfMojoGenerator(MojoGenerator):
    """The end-to-end perf protocol: prefill latency at each of
    ``PREFILL_SEQLENS`` at bs 1 and decode throughput at each of
    ``DECODE_BATCH_SIZES`` at ``DECODE_CONTEXT`` tokens of context, from
    random prompts (``np.random.default_rng(0)``, as the JAX package draws
    them). Each case runs once warm (kernel builds, graph captures), left
    out of the records, then once recorded by ``PerfHook`` (host clock, the
    device synchronized at each phase boundary). ``fused=True`` adds whole
    ``FusedDecode`` windows of ``max_new_tokens`` steps at each batch size,
    timed with CUDA events on the card (the host clock on the CPU)."""

    PREFILL_SEQLENS = (512, 1024, 2048, 4096, 8192)
    DECODE_BATCH_SIZES = (1, 2, 4, 8, 16, 24)
    DECODE_CONTEXT = 4000

    def __init__(self, *args, **kwargs):
        hooks = list(kwargs.pop("hooks", None) or [])
        self.perf_hook = PerfHook(silent=True)
        hooks.append(self.perf_hook)
        super().__init__(*args, hooks=hooks, **kwargs)

    def _random_prompts(self, batch_size: int, seqlen: int):
        config = getattr(getattr(self.model, "model", None), "config", None)
        vocab_size = getattr(getattr(config, "model_config", None), "vocab_size", 0) or 32000
        rng = np.random.default_rng(0)
        ids = rng.integers(0, vocab_size, (batch_size * seqlen,)).astype(np.int32)
        return ids, np.full((batch_size,), seqlen, np.int32)

    def _run_perf_case(self, batch_size: int, seqlen: int, max_decode_steps: int) -> None:
        ids, lens = self._random_prompts(batch_size, seqlen)
        n_before = len(self.perf_hook.records)
        self.generate_from_ids(ids, lens, max_decode_steps=max_decode_steps, ignore_eos=True, silent=True)
        del self.perf_hook.records[n_before:]  # the warm run
        self.generate_from_ids(ids, lens, max_decode_steps=max_decode_steps, ignore_eos=True, silent=True)

    def _run_fused_decode_case(self, batch_size: int) -> dict:
        """A whole FusedDecode window after the context's prefill, twice
        warm (capture and settle), then timed."""
        ids, lens = self._random_prompts(batch_size, self.DECODE_CONTEXT)
        logits, session = self.model(ids, context_input_len=lens)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        steps = self.max_new_tokens
        fused = FusedDecode(self.model.model, sample_method="greedy",
                            device_graph=getattr(self.model, "device_graph", None))
        for _ in range(2):
            tok = fused(session, tok, steps)[-1]
        timer = "events" if tok.is_cuda else "host"
        seconds = chain_seconds(lambda: fused(session, tok, steps), tok.device, timer)
        return {"batch_size": batch_size, "decode_steps": steps, "decode_avg_ms": seconds / steps * 1e3,
                "throughput": batch_size * steps / seconds, "timer": timer}

    def __call__(self, prompts=None, prefill_seqlens=None, decode_batch_sizes=None, fused: bool = False) -> dict:
        """Returns ``{"prefill": [...], "decode": [...], "fused_decode": [...]}``
        (``PerfHook`` records; the fused ones as ``_run_fused_decode_case``)."""
        logger.info("Starting Prefill Latency Tests...")
        self.perf_hook.records.clear()
        for seqlen in prefill_seqlens or self.PREFILL_SEQLENS:
            self._run_perf_case(batch_size=1, seqlen=seqlen, max_decode_steps=1)
        prefill_records = list(self.perf_hook.records)

        log_table(logger, "=" * 60)
        log_table(logger, f"{'Prefill Latency Tests':^60}")
        log_table(logger, f"{'SeqLen':<15} | {'Batch Size':<15} | {'Prefill Latency (ms)':<20}")
        for r in prefill_records:
            log_table(logger, f"{r['in_tok']:<15} | {r['batch_size']:<15} | {r['prefill_ms']:<20.2f}")

        logger.info("Starting Decode Throughput Tests...")
        self.perf_hook.records.clear()
        for bs in decode_batch_sizes or self.DECODE_BATCH_SIZES:
            self._run_perf_case(batch_size=bs, seqlen=self.DECODE_CONTEXT, max_decode_steps=self.max_new_tokens)
        decode_records = list(self.perf_hook.records)

        header = (f"{'Batch Size':<12} | {'Decode Steps':<15} | {'Avg Latency (ms/step)':<22} | "
                  f"{'Throughput (tok/s)':<20}")
        fused_records = []
        if fused:
            logger.info("Starting FUSED Decode Throughput Tests...")
            fused_records = [self._run_fused_decode_case(bs) for bs in decode_batch_sizes or self.DECODE_BATCH_SIZES]
            log_table(logger, "=" * 80)
            log_table(logger, f"{'Fused Decode Throughput (one FusedDecode window)':^80}")
            log_table(logger, header)
            for r in fused_records:
                log_table(logger, f"{r['batch_size']:<12} | {r['decode_steps']:<15} | "
                                  f"{r['decode_avg_ms']:<22.2f} | {r['throughput']:<20.2f}")

        log_table(logger, "=" * 80)
        log_table(logger, f"{'Decode Throughput Tests (Context Len = %d)' % self.DECODE_CONTEXT:^80}")
        log_table(logger, header)
        for r in decode_records:
            log_table(logger, f"{r['batch_size']:<12} | {r['decode_steps']:<15} | "
                              f"{r['decode_avg_ms']:<22.2f} | {r['throughput']:<20.2f}")
        return {"prefill": prefill_records, "decode": decode_records, "fused_decode": fused_records}
