"""Port of `repro.launch`, so far the LM serving launcher (`serve`), the
input-shape registry (`shapes`) and the federated service loop
(`fed_serve`); training, the dry run and the mesh are ROADMAP.md §1 items
13 and 18."""
