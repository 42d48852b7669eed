// Native implementation of the synthetic Markov-chain walk.
//
// The port's own copy of spotlight_tpu/native/markov.cpp.  The sequential
// part of the synthetic dataset generator (an order-k chain where each step
// averages the cumulative transition rows of the last k states and inverts
// the CDF via searchsorted) is irreducibly serial, so it lives on the host;
// this C++ version replaces the per-step numpy loop of
// spotlight_tpu_torch/data/synthetic.py.
//
// Bit-identical to the numpy implementation: the mean-CDF value at a probe
// position is computed with the same operation order (sum the k rows'
// entries in window order, then divide by k) and compared with numpy
// searchsorted 'left' semantics — and only O(order * log N) positions are
// evaluated per step instead of materializing the O(order * N) mean row,
// so it is faster both by constant factor and asymptotically.
//
// Plain C ABI (called via ctypes; no pybind11 dependency).

#include <cstdint>

extern "C" {

// cumulative: (num_states, num_states) row-major cumulative transition rows.
// rvs:        (num_steps,) uniform [0, 1) draws.
// state:      (order,) initial state window; updated in place.
// out:        (num_steps,) generated states.
void markov_walk(const double* cumulative, int64_t num_states, int64_t order,
                 const double* rvs, int64_t num_steps, int64_t* state,
                 int32_t* out) {
    const double order_d = static_cast<double>(order);

    for (int64_t step = 0; step < num_steps; ++step) {
        const double rv = rvs[step];

        // searchsorted(mean_row, rv, side='left'): first idx with
        // mean_row[idx] >= rv.
        int64_t lo = 0, hi = num_states;
        while (lo < hi) {
            const int64_t mid = (lo + hi) / 2;
            double acc = 0.0;
            for (int64_t w = 0; w < order; ++w) {
                acc += cumulative[state[w] * num_states + mid];
            }
            const double mean_val = acc / order_d;
            if (mean_val < rv) {
                lo = mid + 1;
            } else {
                hi = mid;
            }
        }
        const int64_t new_state =
            lo < num_states - 1 ? lo : num_states - 1;

        for (int64_t w = 0; w + 1 < order; ++w) state[w] = state[w + 1];
        state[order - 1] = new_state;
        out[step] = static_cast<int32_t>(new_state);
    }
}

}  // extern "C"
