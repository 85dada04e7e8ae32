"""Batched differential fuzzing of artifacts: corpora, oracle, engine, CLI."""
