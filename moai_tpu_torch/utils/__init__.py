"""Harness-side utilities (never imported by op or model code)."""
