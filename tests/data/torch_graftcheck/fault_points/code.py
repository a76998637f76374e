from tfidf_tpu_torch.utils.faults import fault_point


def f():
    fault_point("known.point")
    fault_point("rogue.point")
