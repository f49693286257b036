"""Bootstrapping.  So far only the Chebyshev evaluators of ``evalmod``,
which GELU and the rsqrt use; CoeffToSlot, EvalMod and SlotToCoeff come
with the bootstrap slice."""
