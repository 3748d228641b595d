"""Port of `repro.launch`, so far the serving launcher (`serve`) and the
input-shape registry (`shapes`); training, the dry run and the mesh are
ROADMAP.md §1 items 13 and 18."""
