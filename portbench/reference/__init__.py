"""The benchmark's plain reference: imports torch alone, nothing of the
program under test."""
