"""Edge-partitioned execution of one graph: the ``edge`` mesh, the host
partition with its boundary halo lists, the halo all-to-all kernel and the
distributed GCN_FC forward."""
