"""Tests of the benchmark (CPU, and the card where marked cuda)."""
