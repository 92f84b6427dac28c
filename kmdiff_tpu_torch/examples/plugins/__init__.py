"""Example model plugins: load one with --model PATH or --model MODULE[:FACTORY]."""
