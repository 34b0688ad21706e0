"""The port benchmark's harness: registry, traffic loops, traces, checks."""
