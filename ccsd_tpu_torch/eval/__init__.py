"""Graph and lifted-CC MMD evaluation on adjacency arrays.

Port copies of ccsd_tpu/eval/{mmd,stats,cc_stats}.py and the native orbit
counter, without networkx: a graph is the cleaned 0/1 adjacency that
``graphs.adjs_to_graphs`` makes, and each statistic reproduces the
networkx computation the JAX package runs, value for value.
"""
