"""The model substrate: the serving path of the JAX package's
``repro.models`` (layers, MoE, SSM, the decoder-only stack, the
encoder-decoder and the ``build`` API) as PyTorch modules."""
