"""Seeded lockdep inversion: two locks made through a port module's
``threading`` (the witness's proxy once installed), taken in both
orders."""


def test_both_orders():
    from tfidf_tpu_torch.cluster import coordination
    a = coordination.threading.Lock()
    b = coordination.threading.Lock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass
