"""Port of `repro.launch`: the LM serving and training launchers (`serve`,
`train`), the input-shape registry and spec builders (`shapes`), the
client groups and LM meshes over `torch.distributed` (`mesh`), the dry run
on the production mesh (`dryrun`) and the federated service loop
(`fed_serve`)."""
