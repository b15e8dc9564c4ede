from repro_torch.baselines.brute_force import (mips_topk, order_desc_stable,
                                               recall_at_k, search_topk)
