"""The plain reference of the port's timed paths: plain PyTorch, no import of the port."""
