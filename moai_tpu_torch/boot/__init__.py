"""Bootstrapping: the Chebyshev evaluators and ModReducer (``evalmod``),
the CoeffToSlot/SlotToCoeff linear transforms (``linear``), and the
Bootstrapper with its ``make_refresh`` adapter (``bootstrap``)."""
