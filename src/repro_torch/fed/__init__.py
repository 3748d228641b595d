"""Port of `repro.fed`: the BL-DNN workload (`bldnn`)."""
