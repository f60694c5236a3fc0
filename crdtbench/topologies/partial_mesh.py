"""The circulant partial mesh of the paper's Figure 6 (left): replica n
linked with n ± 1 .. n ± degree/2 (mod N), neighbours in ascending id
order."""

from crdtbench.reference.crdt import mesh_lists as neighbours  # noqa: F401


def program(nodes: int, degree: int):
    from repro_torch.sync import topology

    return topology.partial_mesh(nodes, degree)
