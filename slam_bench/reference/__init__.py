"""Plain references that decide whether a run is correct. They import
nothing of the SLAM package, of JAX or of the JAX package."""
