"""moai_tpu_torch — the CKKS FHE library and encrypted-attention runtime of
``moai_tpu``, in PyTorch, with hand-written CUDA NTT kernels for Hopper.

Residues are int64 tensors holding the same Montgomery values the JAX
package holds in uint32, so every integer result is bit-identical to it.
Entry points take a ``device`` argument that defaults to ``"cuda"`` and
raise when no card is present; ``device="cpu"`` runs the plain PyTorch path.
"""

__version__ = "0.1.0"
