"""pop_pca_s: popstrat's PCA in wall seconds (the command's timings["pca"]:
the geno matrix read back, K-GRAM's Gram over its row-sum groups, the f64
eigh and pcs.evec), the mean over the window's jobs, which run without the
profiler; nothing where the jobs have no such key."""


def read(ctx: dict):
    secs = [j["phases"]["pca"] for j in ctx["jobs"] if "pca" in j["phases"]]
    return sum(secs) / len(secs) if secs else None
