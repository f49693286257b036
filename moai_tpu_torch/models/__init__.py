"""Encrypted transformer models."""
