"""The port's example entry points, each run as
``python -m mojo_opset_tpu_torch.examples.<name>`` (``--help`` lists the
flags): ``llm_inference`` (a Qwen3 generation, from an HF checkpoint with
``--checkpoint DIR``), ``qwen3_patch`` (an HF Qwen3 checkpoint into the
port's model, held to transformers with ``--verify``), ``continuous_serving``
(a request stream through the continuous batcher) and ``dit_inference`` (a
Wan2.2 DiT denoising loop, from a checkpoint with ``--ckpt-dir DIR``). Each
runs on the card unless ``--device cpu`` is given, with random weights
drawn from a seeded ``torch.Generator`` on the device where no checkpoint
is named, and its ``main(argv=None)`` returns what it prints.
"""
