"""Observability (``debug``: op traces, spans, probes) and harness-side
utilities (``recrypt``, never imported by op or model code)."""
