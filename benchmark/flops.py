"""Model FLOPs from the shapes a cell runs (2 a multiply-add), counting the
dense layers only: what a step or a forward must compute whatever
implements it. Training counts three forwards (the backward twice the
forward), with no recomputation."""

from __future__ import annotations


def detector_forward_macs(input_pc_num: int, node_num: int, c1: int,
                          c2: int, node_knn_k: int, surface_normal_len: int
                          ) -> int:
    """One cloud through the SOM detector: the two per-point PointNets,
    the kNN fusion with its split layer (the per-neighbour rows and, once
    a node, the max's rows), the head."""
    n, m, k = input_pc_num, node_num, node_knn_k
    c = c2 // 2
    cin = 3 + surface_normal_len
    pn1 = n * (cin * (c1 // 2) + 2 * (c1 // 2) ** 2)
    pn2 = n * (c1 * c1 + c1 * c1)
    rows = m * k
    fusion = rows * ((3 + c1) * c + 2 * c * c + c * c2 + c2 * c2) + m * c * c2
    head = m * ((c1 + c2) * 512 + 512 * 256 + 256 * 4)
    return pn1 + pn2 + fusion + head


def detector_forward_flops(sizes: dict) -> float:
    return 2.0 * detector_forward_macs(
        sizes["input_pc_num"], sizes["node_num"], sizes["c1"], sizes["c2"],
        sizes["node_knn_k"], sizes["surface_normal_len"])


def detector_train_flops(sizes: dict) -> float:
    """A cloud's share of a train step."""
    return 3.0 * detector_forward_flops(sizes)


def descriptor_forward_macs(node_num: int, ball_nsamples: int,
                            descriptor_len: int, surface_normal_len: int
                            ) -> int:
    """One cloud's ``node_num`` balls of ``ball_nsamples`` points through
    the descriptor: three dense layers, the dense layer over each row and
    its ball's max, the last dense layer."""
    d = descriptor_len
    rows = node_num * ball_nsamples
    cin = 3 + surface_normal_len
    return rows * (cin * (d // 4) + (d // 4) * (d // 2) + (d // 2) * d
                   + 2 * d * d + d * d)


def descriptor_train_flops(sizes: dict) -> float:
    """A cloud's share of a descriptor train step: the frozen detector's
    forward once, the descriptor's three times."""
    desc = 2.0 * descriptor_forward_macs(
        sizes["node_num"], sizes["ball_nsamples"], sizes["descriptor_len"],
        sizes["surface_normal_len"])
    return detector_forward_flops(sizes) + 3.0 * desc
