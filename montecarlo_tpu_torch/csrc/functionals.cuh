// K4's path functionals: the codes, the host-folded parameters and the
// fold (init, update after every step, finalize) of engine/functionals.py's
// device forms, and the observation each functional takes.
//
// Two folds of the same arithmetic.  SpecFold takes the codes as data
// (FunctionalSpec) and runs every slot through a switch at every
// observation, four accumulators a slot: the generic fold, for any set.
// FixedFold<Codes...> fixes the set at compile time (JAX compiles each set
// into its own kernel, ops/fused_engine.py::_make_functional_kernel): each
// slot's update is straight-line code, keeps only the accumulators its
// code uses, observes the price or the log price as chosen at compile
// time, and replaces `t % period == 0` by an integer countdown (the
// updates come with t = 1, 2, ... in order, so both are true at the same
// steps).  FixedFolds lists the sets K4 is built for; with_fold picks the
// one that a spec names, or SpecFold.  SnapshotFold is the snapshot
// kernel's: a set of price snapshots only, latched at their steps.
//
// Written as __host__ __device__ functions so that the same text runs in
// K4 (csrc/fused_engine.cuh, nvcc) and in the host shims of
// tests/test_torch_basket_step.py and tests/test_torch_fold.py (g++),
// which walk K4's per-path loop bitwise against ops/fused_engine.py::
// fused_functionals_reference.
#pragma once

#include <stdint.h>

#include "rng.cuh"

namespace mcf {

// engine/functionals.py::*_CODE.
enum FunctionalCode {
  kArithMean = 0,
  kGeoMean = 1,
  kRunningMax = 2,
  kRunningMin = 3,
  kBarrierUp = 4,    // params: log_b, inv
  kCliquet = 5,      // period; params: floor, cap
  kAutocall = 6,     // period; params: -r_dt, trigger, coupon, pdi, s0,
                     //         -r_dt * n_steps
  kRealizedVar = 7,
  kTrapezoid = 8,    // params: half_dt
  kSnapshot = 9,     // period: the step it latches (0: the spot)
};

constexpr int kMaxFunctionals = 4;
constexpr int kMaxParams = 6;

struct FunctionalSpec {
  int64_t out_stride;  // row stride of out (the whole run's path count)
  int n;
  int code[kMaxFunctionals];
  int period[kMaxFunctionals];
  float p[kMaxFunctionals][kMaxParams];
};

MC_HD constexpr bool log_space(int code) {
  return code == kGeoMean || code == kRunningMax || code == kRunningMin ||
         code == kBarrierUp || code == kRealizedVar;
}

// Which observations the spec's functionals take: the price, its log.
struct Needs {
  bool price, log;
};

MC_HD Needs needs(const FunctionalSpec& spec) {
  Needs n{false, false};
#pragma unroll
  for (int k = 0; k < kMaxFunctionals; ++k) {
    if (k < spec.n) {
      if (log_space(spec.code[k])) {
        n.log = true;
      } else {
        n.price = true;
      }
    }
  }
  return n;
}

// The observation of each functional slot: the price or the log price.
MC_HD void observations(const FunctionalSpec& spec, float price, float logp,
                        float* obs) {
#pragma unroll
  for (int k = 0; k < kMaxFunctionals; ++k) {
    obs[k] = log_space(spec.code[k]) ? logp : price;
  }
}

// init(obs0) of engine/functionals.py.
MC_HD void fn_init(int code, int period, const float* p, float obs,
                   float* acc) {
  switch (code) {
    case kBarrierUp:
      acc[0] = obs < p[0] ? 1.0f : 0.0f;
      acc[1] = obs;
      break;
    case kCliquet:
    case kRealizedVar:
    case kTrapezoid:
      acc[0] = 0.0f;
      acc[1] = obs;
      break;
    case kAutocall:
      acc[0] = 1.0f;
      acc[1] = 0.0f;
      acc[2] = obs;
      acc[3] = obs;
      break;
    case kSnapshot:  // the spot for step 0, else 0 until its step
      acc[0] = period == 0 ? obs : 0.0f;
      break;
    default:  // means, running max / min
      acc[0] = obs;
  }
}

// update(acc, obs, t) with t the 1-based step index.
MC_HD void fn_update(int code, int period, const float* p, float obs, int t,
                     float* acc) {
  switch (code) {
    case kArithMean:
    case kGeoMean:
      acc[0] = acc[0] + obs;
      break;
    case kRunningMax:
      acc[0] = fmaxf(acc[0], obs);
      break;
    case kRunningMin:
      acc[0] = fminf(acc[0], obs);
      break;
    case kBarrierUp: {
      const float a = p[0] - acc[1];
      const float b = p[0] - obs;
      const float p_cross = mc::exp32(((-2.0f * a) * b) * p[1]);
      const bool alive = (a > 0.0f) && (b > 0.0f);
      acc[0] = acc[0] * (alive ? 1.0f - p_cross : 0.0f);
      acc[1] = obs;
      break;
    }
    case kCliquet:
      if (t % period == 0) {
        const float ret = fminf(fmaxf(obs / acc[1] - 1.0f, p[0]), p[1]);
        acc[0] = acc[0] + ret;
        acc[1] = obs;
      }
      break;
    case kAutocall: {
      acc[2] = fminf(acc[2], obs);
      if (t % period == 0 && acc[0] > 0.5f && obs >= p[1]) {
        const float tf = (float)t;
        const float j = tf / (float)period;
        acc[1] = (1.0f + p[2] * j) * mc::exp32(p[0] * tf);
        acc[0] = 0.0f;
      }
      acc[3] = obs;
      break;
    }
    case kRealizedVar: {
      const float d = obs - acc[1];
      acc[0] = acc[0] + d * d;
      acc[1] = obs;
      break;
    }
    case kTrapezoid:
      acc[0] = acc[0] + (acc[1] + obs) * p[0];
      acc[1] = obs;
      break;
    case kSnapshot:
      if (t == period) acc[0] = obs;
      break;
  }
}

// finalize(acc, float(n_steps)).
MC_HD float fn_finalize(int code, const float* p, const float* acc,
                        int n_steps) {
  const float n_obs = (float)(n_steps + 1);  // n_steps + 1.0, exact
  switch (code) {
    case kArithMean:
      return acc[0] / n_obs;
    case kGeoMean:
      return mc::exp32(acc[0] / n_obs);
    case kRunningMax:
    case kRunningMin:
      return mc::exp32(acc[0]);
    case kAutocall: {
      if (acc[0] <= 0.5f) return acc[1];
      const float df_t = mc::exp32(p[5]);
      const bool breached = acc[2] <= p[3];
      return df_t * (breached ? fminf(acc[3] / p[4], 1.0f) : 1.0f);
    }
    default:  // barrier survival, cliquet leg, sums, snapshot
      return acc[0];
  }
}

// ---- The generic fold: the codes are data ------------------------------------

// The fold K4 runs over the state's observations: init(spec, price, logp)
// on the initial state, update(spec, price, logp, t) after step t - 1 (t
// the 1-based step index), finalize(spec, out, i, n_steps) writes row k + 1
// of column i for each slot k.  needs(spec) says which observations it
// reads.
struct SpecFold {
  float acc[kMaxFunctionals][4];
  MC_HD static Needs needs(const FunctionalSpec& spec) {
    return mcf::needs(spec);
  }
  MC_HD void init(const FunctionalSpec& spec, float price, float logp) {
    float obs[kMaxFunctionals];
    observations(spec, price, logp, obs);
#pragma unroll
    for (int k = 0; k < kMaxFunctionals; ++k) {
      if (k < spec.n) {
        fn_init(spec.code[k], spec.period[k], spec.p[k], obs[k], acc[k]);
      }
    }
  }
  MC_HD void update(const FunctionalSpec& spec, float price, float logp,
                    int t) {
    float obs[kMaxFunctionals];
    observations(spec, price, logp, obs);
#pragma unroll
    for (int k = 0; k < kMaxFunctionals; ++k) {
      if (k < spec.n) {
        fn_update(spec.code[k], spec.period[k], spec.p[k], obs[k], t, acc[k]);
      }
    }
  }
  MC_HD void finalize(const FunctionalSpec& spec, float* out, int64_t i,
                      int n_steps) const {
#pragma unroll
    for (int k = 0; k < kMaxFunctionals; ++k) {
      if (k < spec.n) {
        out[(k + 1) * spec.out_stride + i] =
            fn_finalize(spec.code[k], spec.p[k], acc[k], n_steps);
      }
    }
  }
};

// ---- The fold fixed at compile time ------------------------------------------

// One slot of code Code: the same operations as fn_init, fn_update and
// fn_finalize for that code, on the accumulators it uses.  kLog: it
// observes the log price (log_space).  update gets the slot's period and t.
template <int Code>
struct Slot;

template <>
struct Slot<kArithMean> {
  static constexpr bool kLog = false;
  float sum;
  MC_HD void init(const float*, int, float obs) { sum = obs; }
  MC_HD void update(const float*, int, float obs, int) { sum = sum + obs; }
  MC_HD float finalize(const float*, int n_steps) const {
    return sum / (float)(n_steps + 1);
  }
};

template <>
struct Slot<kGeoMean> {
  static constexpr bool kLog = true;
  float sum;
  MC_HD void init(const float*, int, float obs) { sum = obs; }
  MC_HD void update(const float*, int, float obs, int) { sum = sum + obs; }
  MC_HD float finalize(const float*, int n_steps) const {
    return mc::exp32(sum / (float)(n_steps + 1));
  }
};

template <>
struct Slot<kRunningMax> {
  static constexpr bool kLog = true;
  float m;
  MC_HD void init(const float*, int, float obs) { m = obs; }
  MC_HD void update(const float*, int, float obs, int) { m = fmaxf(m, obs); }
  MC_HD float finalize(const float*, int) const { return mc::exp32(m); }
};

template <>
struct Slot<kRunningMin> {
  static constexpr bool kLog = true;
  float m;
  MC_HD void init(const float*, int, float obs) { m = obs; }
  MC_HD void update(const float*, int, float obs, int) { m = fminf(m, obs); }
  MC_HD float finalize(const float*, int) const { return mc::exp32(m); }
};

template <>
struct Slot<kBarrierUp> {  // p: log_b, inv
  static constexpr bool kLog = true;
  float surv, prev;
  MC_HD void init(const float* p, int, float obs) {
    surv = obs < p[0] ? 1.0f : 0.0f;
    prev = obs;
  }
  MC_HD void update(const float* p, int, float obs, int) {
    const float a = p[0] - prev;
    const float b = p[0] - obs;
    const float p_cross = mc::exp32(((-2.0f * a) * b) * p[1]);
    const bool alive = (a > 0.0f) && (b > 0.0f);
    surv = surv * (alive ? 1.0f - p_cross : 0.0f);
    prev = obs;
  }
  MC_HD float finalize(const float*, int) const { return surv; }
};

template <>
struct Slot<kCliquet> {  // p: floor, cap
  static constexpr bool kLog = false;
  float sum, last;
  int left;  // updates to the next reset
  MC_HD void init(const float*, int period, float obs) {
    sum = 0.0f;
    last = obs;
    left = period;
  }
  MC_HD void update(const float* p, int period, float obs, int) {
    if (--left == 0) {
      left = period;
      const float ret = fminf(fmaxf(obs / last - 1.0f, p[0]), p[1]);
      sum = sum + ret;
      last = obs;
    }
  }
  MC_HD float finalize(const float*, int) const { return sum; }
};

template <>
struct Slot<kAutocall> {  // p: -r_dt, trigger, coupon, pdi, s0, -r_dt T
  static constexpr bool kLog = false;
  bool alive;
  float pay, mn, last;
  int left;  // updates to the next observation date
  MC_HD void init(const float*, int period, float obs) {
    alive = true;
    pay = 0.0f;
    mn = obs;
    last = obs;
    left = period;
  }
  MC_HD void update(const float* p, int period, float obs, int t) {
    mn = fminf(mn, obs);
    if (--left == 0) {
      left = period;
      if (alive && obs >= p[1]) {
        const float tf = (float)t;
        const float j = tf / (float)period;
        pay = (1.0f + p[2] * j) * mc::exp32(p[0] * tf);
        alive = false;
      }
    }
    last = obs;
  }
  MC_HD float finalize(const float* p, int) const {
    if (!alive) return pay;
    const float df_t = mc::exp32(p[5]);
    const bool breached = mn <= p[3];
    return df_t * (breached ? fminf(last / p[4], 1.0f) : 1.0f);
  }
};

template <>
struct Slot<kRealizedVar> {
  static constexpr bool kLog = true;
  float sum, prev;
  MC_HD void init(const float*, int, float obs) {
    sum = 0.0f;
    prev = obs;
  }
  MC_HD void update(const float*, int, float obs, int) {
    const float d = obs - prev;
    sum = sum + d * d;
    prev = obs;
  }
  MC_HD float finalize(const float*, int) const { return sum; }
};

template <>
struct Slot<kTrapezoid> {  // p: half_dt
  static constexpr bool kLog = false;
  float sum, prev;
  MC_HD void init(const float*, int, float obs) {
    sum = 0.0f;
    prev = obs;
  }
  MC_HD void update(const float* p, int, float obs, int) {
    sum = sum + (prev + obs) * p[0];
    prev = obs;
  }
  MC_HD float finalize(const float*, int) const { return sum; }
};

// Slots K, K + 1, ... of a fixed fold, one member each.
template <int K, int... Codes>
struct Slots {
  MC_HD void init(const FunctionalSpec&, float, float) {}
  MC_HD void update(const FunctionalSpec&, float, float, int) {}
  MC_HD void finalize(const FunctionalSpec&, float*, int64_t, int) const {}
};

template <int K, int C, int... Rest>
struct Slots<K, C, Rest...> {
  Slot<C> head;
  Slots<K + 1, Rest...> tail;
  MC_HD static float pick(float price, float logp) {
    return Slot<C>::kLog ? logp : price;
  }
  MC_HD void init(const FunctionalSpec& s, float price, float logp) {
    head.init(s.p[K], s.period[K], pick(price, logp));
    tail.init(s, price, logp);
  }
  MC_HD void update(const FunctionalSpec& s, float price, float logp,
                    int t) {
    head.update(s.p[K], s.period[K], pick(price, logp), t);
    tail.update(s, price, logp, t);
  }
  MC_HD void finalize(const FunctionalSpec& s, float* out, int64_t i,
                      int n_steps) const {
    out[(K + 1) * s.out_stride + i] = head.finalize(s.p[K], n_steps);
    tail.finalize(s, out, i, n_steps);
  }
};

// The fold of the functional set Codes, in slot order; SpecFold's
// interface, its needs known at compile time.
template <int... Codes>
struct FixedFold {
  static constexpr int kN = sizeof...(Codes);
  static constexpr bool kPrice = (... || !log_space(Codes));
  static constexpr bool kLog = (... || log_space(Codes));
  Slots<0, Codes...> slots;
  MC_HD static Needs needs(const FunctionalSpec&) { return Needs{kPrice, kLog}; }
  // Whether `spec` is this set: the same codes in the same slots.
  MC_HD static bool names(const FunctionalSpec& spec) {
    const int codes[kN] = {Codes...};
    if (spec.n != kN) return false;
    for (int k = 0; k < kN; ++k) {
      if (spec.code[k] != codes[k]) return false;
    }
    return true;
  }
  MC_HD void init(const FunctionalSpec& spec, float price, float logp) {
    slots.init(spec, price, logp);
  }
  MC_HD void update(const FunctionalSpec& spec, float price, float logp,
                    int t) {
    slots.update(spec, price, logp, t);
  }
  MC_HD void finalize(const FunctionalSpec& spec, float* out, int64_t i,
                      int n_steps) const {
    slots.finalize(spec, out, i, n_steps);
  }
};

template <class... Folds>
struct FoldList {};

// The sets the main paths launch, which K4 is built for: {avg} (the Asian
// CLI, the Sobol and bridge Asians, the basket and term basket Asians,
// Kou, VG, SLV), {avg, mx, mn} (the app's set, GARCH's), {surv} (the
// bridge barriers), the autocall note, the cliquet leg and {trap} (the
// bond command's discount integral), in that order: an entry's index is
// what mc_fused_functionals reports, so a new set goes last.  Which
// process and draw source take each is the kernels' choice (FixedFor:
// csrc/fused_k4.cu, fused_basket.cuh, fused_rates.cu,
// fused_term_basket_k4.cu).
using FixedFolds =
    FoldList<FixedFold<kArithMean>,
             FixedFold<kArithMean, kRunningMax, kRunningMin>,
             FixedFold<kBarrierUp>, FixedFold<kAutocall>,
             FixedFold<kCliquet>, FixedFold<kTrapezoid>>;

// The index in FixedFolds of the set `spec` names, or -1.
template <class... Folds>
MC_HD int fixed_fold_index(FoldList<Folds...>, const FunctionalSpec& spec) {
  int k = 0, found = -1;
  (void)((Folds::names(spec) ? (found = k, true) : (++k, false)) || ...);
  return found;
}
MC_HD int fixed_fold_index(const FunctionalSpec& spec) {
  return fixed_fold_index(FixedFolds{}, spec);
}

// f(fold) with the fold of `spec`: its FixedFolds entry, or SpecFold.
template <class F, class... Folds>
auto with_fold(FoldList<Folds...>, const FunctionalSpec& spec, F&& f)
    -> decltype(f(SpecFold{})) {
  decltype(f(SpecFold{})) r{};
  const bool fixed = ((Folds::names(spec) && (r = f(Folds{}), true)) || ...);
  return fixed ? r : f(SpecFold{});
}
template <class F>
auto with_fold(const FunctionalSpec& spec, F&& f) -> decltype(f(SpecFold{})) {
  return with_fold(FixedFolds{}, spec, f);
}

// ---- The snapshot fold: prices latched at their steps -----------------------

// The most snapshots one launch of the snapshot kernel takes
// (csrc/fused_k4_snapshot.cu): a surface's maturity grid before its last.
constexpr int kMaxSnapshots = 64;

// A launch's snapshots, by value, sorted by step on the host
// (ops/fused_engine.py::fused_snapshots): snapshot k latches the price
// after step[k] steps (0: the spot; a step past the run's last is written
// 0) into output row row[k] + 1.
struct SnapshotPlan {
  int64_t out_stride;  // row stride of out (the launch's path count)
  int n;
  int step[kMaxSnapshots];
  int row[kMaxSnapshots];
};

// K4 on a set of snapshots only, kSnapshot's fold without the generic
// fold's switch and accumulators: every path has the same steps, so one
// cursor walks the sorted plan, and the time loop asks at each step only
// whether it is the cursor's (`due`, one integer compare, the same answer
// for every thread).  At such a step the kernel takes the price of the
// state, which the fold stores straight to each row that latches it;
// the snapshots of the last step get the terminal price at finalize, and
// those past it 0, as kSnapshot's fold leaves them.  The price is thus
// computed only at a latched step and at the end, the same prices() of
// the same states as the generic fold takes at every step.
struct SnapshotFold {
  int next;  // the first snapshot not yet latched
  int due;   // its step while that lies before the last step, else -1
  MC_HD void seek(const SnapshotPlan& p, int n_steps) {
    due = next < p.n && p.step[next] < n_steps ? p.step[next] : -1;
  }
  MC_HD void init(const SnapshotPlan& p, int n_steps) {
    next = 0;
    seek(p, n_steps);
  }
  // Whether the state after step t (0: the initial state) is latched.
  MC_HD bool due_at(int t) const { return t == due; }
  // Latches `price`, the price after step t, into every row of step t
  // (stores only when `store`: a thread past the paths) and moves on.
  MC_HD void latch(const SnapshotPlan& p, int n_steps, int t, float price,
                   float* out, int64_t i, bool store) {
    for (; next < p.n && p.step[next] == t; ++next) {
      if (store) out[(p.row[next] + 1) * p.out_stride + i] = price;
    }
    seek(p, n_steps);
  }
  // The snapshots of the last step get the terminal price, the rest 0.
  MC_HD void finalize(const SnapshotPlan& p, int n_steps, float terminal,
                      float* out, int64_t i) {
    latch(p, n_steps, n_steps, terminal, out, i, true);
    for (; next < p.n; ++next) {
      out[(p.row[next] + 1) * p.out_stride + i] = 0.0f;
    }
  }
};

}  // namespace mcf
