"""The repo's four examples (``examples/*.py``) through the port's API,
each a module: ``python -m repro_torch.examples.<name>``, on the card by
default, ``--device cpu`` on the CPU (the kernels' plain versions).

* :mod:`.quickstart`: the XNOR-popcount GEMM and the bit-plane first
  layer, each equal to its exact integer form;
* :mod:`.bitplane_first_layer`: the bit-plane identity of a dense first
  layer, and the work accounting;
* :mod:`.train_binary_mlp`: STE training with latent clipping, then the
  packed BMLP classifying as the training-time net does;
* :mod:`.serve_binary_lm`: a reduced binary-weight LM through
  ``BatchedServer``.

Each ``main(argv)`` returns 0 once its checks hold and raises where one
fails.
"""
