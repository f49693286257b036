"""moai_tpu_torch — the CKKS FHE library and encrypted-attention runtime of
``moai_tpu``, in PyTorch, with hand-written CUDA kernels for Hopper (the
NTT and the limb arithmetic).

Residues are int32 tensors, on the card and on the CPU, holding the same
Montgomery values (below 2^30) the JAX package holds in uint32, so every
integer result is bit-identical to it.
Entry points take a ``device`` argument that defaults to ``"cuda"`` and
raise when no card is present; ``device="cpu"`` runs the plain PyTorch path.
"""

__version__ = "0.1.0"
