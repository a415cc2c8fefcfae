"""Camera projection models of the renderer, one module per model, found by
the name a configuration's camera block gives (`model`)."""
