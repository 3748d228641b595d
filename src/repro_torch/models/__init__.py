"""Port of `repro.models`, so far only the layer BL-DNN's classifier uses
(`layers.mlp`, non-gated).  The LM stack comes with ROADMAP.md §1 item 18."""
