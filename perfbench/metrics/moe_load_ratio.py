"""The largest expert's load over the mean load (picks per expert), one a
dispatch, averaged over every dispatch of the traced run's requests after
its trace closed (counted by ``drivers.encode_requests.counting_moe``)."""


def read(run):
    m = run.get("moe")
    if not m or not m["dispatches"]:
        return None
    return m["load_ratio_sum"] / m["dispatches"]
