"""Typed config schema and YAML composition of the shared ``configs/`` tree."""
