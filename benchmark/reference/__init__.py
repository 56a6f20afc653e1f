"""The plain reference that decides `correct`: imports nothing of the
program, of JAX or of the JAX package."""
