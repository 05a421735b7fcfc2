// Optimal tensor-network contraction-path planner.
//
// Native runtime component of qmps_torch (a copy of qmps_tpu/native's): exact dynamic programming over
// tensor subsets (Held-Karp style, O(3^n) partitions) minimizing total
// contraction flops.  The reference precomputed *greedy* einsum paths on a
// login node and shipped them to the cluster by pickle
// (new_tdvp/path_calculation_for_myriad.py); here the exact optimum is
// computed natively in microseconds and handed to an einsum.
//
// Interface (ctypes):
//   plan_path(n_tensors, tensor_masks[], n_idx, dims[], out_mask,
//             merges_left[], merges_right[]) -> long long (total flops)
//
// - tensor_masks[i]: bitmask over index ids (< 64) carried by tensor i
// - dims[k]: dimension of index id k
// - out_mask: indices kept in the final result
// - merges_left/right: (n_tensors - 1) subset masks (over *tensor* ids)
//   describing the contraction tree in execution order.
//
// Build: g++ -O3 -shared -fPIC pathfinder.cpp -o libpathfinder.so (the
// loader in __init__.py builds it into qmps_torch/_build/ at first use)

#include <cstddef>
#include <cstdint>
#include <vector>
#include <limits>

namespace {

struct Entry {
    double cost;            // summed flops of the best tree for this subset
    uint64_t idx_mask;      // index ids alive on the subset's result
    uint32_t best_lhs;      // best split (subset of the tensor-id mask)
};

double product_of_dims(uint64_t idx_mask, const long long* dims) {
    double p = 1.0;
    while (idx_mask) {
        int k = __builtin_ctzll(idx_mask);
        p *= static_cast<double>(dims[k]);
        idx_mask &= idx_mask - 1;
    }
    return p;
}

} // namespace

extern "C" long long plan_path(
    int n_tensors,
    const uint64_t* tensor_masks,
    int /*n_idx*/,
    const long long* dims,
    uint64_t out_mask,
    uint32_t* merges_left,
    uint32_t* merges_right)
{
    if (n_tensors < 1 || n_tensors > 20) return -1;
    const uint32_t full = (n_tensors == 32) ? 0xffffffffu
                                            : ((1u << n_tensors) - 1u);

    // external[i]: for tensor subset S, which indices are visible outside S
    // (appear on a tensor not in S, or in the output).
    std::vector<Entry> dp(static_cast<size_t>(full) + 1);
    for (uint32_t S = 1; S <= full; ++S) {
        dp[S].cost = std::numeric_limits<double>::infinity();
        dp[S].best_lhs = 0;
    }

    // index masks of subsets: union of member tensors
    std::vector<uint64_t> union_idx(static_cast<size_t>(full) + 1, 0);
    for (uint32_t S = 1; S <= full; ++S) {
        uint32_t low = S & (S - 1);
        int bit = __builtin_ctz(S);
        union_idx[S] = union_idx[low] | tensor_masks[bit];
    }

    for (int i = 0; i < n_tensors; ++i) {
        uint32_t S = 1u << i;
        // result indices of a single tensor = indices visible outside it
        uint64_t outside = out_mask;
        for (int j = 0; j < n_tensors; ++j)
            if (j != i) outside |= tensor_masks[j];
        dp[S].cost = 0.0;
        dp[S].idx_mask = tensor_masks[i] & outside;
    }

    for (uint32_t S = 1; S <= full; ++S) {
        if (__builtin_popcount(S) < 2) continue;
        uint64_t outside = out_mask | (union_idx[full & ~S]);
        uint64_t result_idx = union_idx[S] & outside;
        // iterate proper sub-subsets; canonical: lhs contains lowest bit
        uint32_t lowbit = S & (uint32_t)(-(int32_t)S);
        for (uint32_t L = (S - 1) & S; L; L = (L - 1) & S) {
            if (!(L & lowbit)) continue;  // halve the enumeration
            uint32_t R = S & ~L;
            if (!R) continue;
            if (dp[L].cost == std::numeric_limits<double>::infinity()) continue;
            if (dp[R].cost == std::numeric_limits<double>::infinity()) continue;
            // flops of the pairwise contraction: product over the union of
            // both operands' live indices
            uint64_t live = dp[L].idx_mask | dp[R].idx_mask;
            double flops = product_of_dims(live, dims);
            double total = dp[L].cost + dp[R].cost + flops;
            if (total < dp[S].cost) {
                dp[S].cost = total;
                dp[S].idx_mask = result_idx;
                dp[S].best_lhs = L;
            }
        }
    }

    // emit merges in post-order (children before parents)
    int pos = 0;
    // iterative post-order over the binary tree rooted at `full`
    std::vector<uint32_t> stack{full};
    std::vector<uint32_t> order;
    while (!stack.empty()) {
        uint32_t S = stack.back();
        stack.pop_back();
        if (__builtin_popcount(S) < 2) continue;
        order.push_back(S);
        stack.push_back(dp[S].best_lhs);
        stack.push_back(S & ~dp[S].best_lhs);
    }
    for (auto it = order.rbegin(); it != order.rend(); ++it) {
        merges_left[pos] = dp[*it].best_lhs;
        merges_right[pos] = *it & ~dp[*it].best_lhs;
        ++pos;
    }
    return static_cast<long long>(dp[full].cost);
}
