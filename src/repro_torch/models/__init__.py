"""The model substrate: the JAX package's ``repro.models`` (layers, MoE,
SSM, the decoder-only stack, the encoder-decoder and the ``build`` API,
with the loss and the train step) as PyTorch modules."""
