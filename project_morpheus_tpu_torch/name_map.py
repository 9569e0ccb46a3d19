"""The JAX package's public names that the port holds under another name or
in another module, or does not hold, each with the reason.

Every public top-level name of every module of ``project_morpheus_tpu``
has a same-named counterpart in the same module here, or an entry below;
``tests/test_torch_surface.py`` holds the two packages to that.  Pallas
arguments that are not ported: ``block_s`` and ``interpret`` (tiling and
interpret mode), ``kv_scale_t`` and ``thread_cache`` (they exist only to
make XLA alias the cache).  ``jax.random`` keys become integer seeds;
orbax checkpoints are not read (safetensors are).
"""

# JAX module -> the port's module holding its names (None: not ported)
MODULES = {
    "codec/snac_jax.py": "codec/snac.py",
    "adapters/local_jax.py": "adapters/local_torch.py",
    # the JAX tests' PyTorch oracle of the SNAC decoder: test-only
    "codec/torch_oracle.py": None,
}

# "JAX module:name" -> "port module:name"
NAMES = {
    "adapters/local_jax.py:LocalJaxAdapter": "adapters/local_torch.py:LocalTorchAdapter",
    "codec/weights.py:to_device": "codec/weights.py:to_torch",
    # works around XLA double-buffering scan outputs; PyTorch has no such
    # problem: llama_forward(..., accum_stack_grads=True)
    "model/llama.py:stack_apply_accum": "model/llama.py:llama_forward",
    "training/pretrain.py:group_layer_params": "model/bridge.py:group_layer_params",
    "training/pretrain.py:ungroup_layer_params": "model/bridge.py:ungroup_layer_params",
}
