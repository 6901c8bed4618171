"""The plain PyTorch reference of OS2D that decides `correct`. It imports
nothing of the port and nothing of JAX."""
