// Native simulator core: C++ twin of the NumPy oracle (the port's own
// copy of traffic_env_tpu/runtime/traffic_native.cpp).
//
// Role: a host-side, single-env reference-semantics stepper (microseconds
// per tick) for long-horizon golden trajectories and the CPU baseline of
// a benchmark.  It is the counterpart of the reference's numba nopython
// layer (traffic_env.py:46-218), written in C++.
//
// Float discipline: everything is IEEE float32 with the same op order
// as traffic_env_tpu_torch/oracle/sim.py (including the explicit
// square-of-square in place of powf and the float32 EPS).  Must be
// compiled with -fno-fast-math -ffp-contract=off so the compiler never
// fuses multiply-adds; see runtime/native.py.
//
// Spawning is data-driven: the caller precomputes the arrival stream
// with NumPy's MT19937 (oracle/spawners.py, envs/spawn.py) and passes
// each tick's entry-road list in, so RNG parity is by construction.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kParams = 10;
constexpr int kCapacity = 20;   // slot 0 reserved as the -1 mirror
constexpr int kYellowTicks = 6;
constexpr float kThresh = 0.2f;
constexpr float kOverflowPenalty = 10.0f;
constexpr float kPassingReward = 0.0f;
constexpr float kDetectRange = 10.0f;
constexpr float kEps = 1e-8f;
constexpr float kInf = std::numeric_limits<float>::infinity();

enum Param { X = 0, V, L, A, DELTA, V0, B, T, S0, W };

// The single car archetype (traffic_env.py:35-43).
const float kArchetype[kParams] = {0.f, 11.11f, 4.f, 3.f, 4.f,
                                   13.89f, 6.f, 2.f, 1.f, 0.f};

inline int ring_next(int i) { return (i + 1 >= kCapacity) ? 1 : i + 1; }

struct Sim {
  // topology
  int roads, train_roads, intersections, m, n;
  float length;
  std::vector<int32_t> dest, nxt, phase_group;
  // state
  std::vector<float> cars;           // [roads][kParams][kCapacity]
  std::vector<int32_t> leading, lastcar, phase, elapsed;
  std::vector<int32_t> passed, detected, waiting;
  std::vector<uint8_t> passed_dst;
  std::vector<float> rewards;
  float steps = 0.f;
  int64_t generated = 0;
  bool learn_switch = false;
  bool decel_penalty = false;
  float rate = 0.5f;
  // validate-mode telemetry
  std::vector<float> trip_times;
  bool collect_trips = false;

  float* car(int road, int p) { return &cars[(road * kParams + p) * kCapacity]; }
};

// IDM update over one follower block; all reads before writes
// (oracle.sim.idm_update).
int idm_block(Sim& s, int road, int ld_lo, int me_lo, int count) {
  if (count <= 0) return 0;
  float* x = s.car(road, X);
  float* v = s.car(road, V);
  float* l = s.car(road, L);
  float* a = s.car(road, A);
  float* v0 = s.car(road, V0);
  float* b = s.car(road, B);
  float* t = s.car(road, T);
  float* s0 = s.car(road, S0);
  // temporaries so every read precedes every write (synchronous update)
  std::vector<float> nx(count), nv(count);
  int n_decel = 0;  // DECEL_PENALTY count (traffic_env.py:196-198)
  for (int j = 0; j < count; ++j) {
    const int me = me_lo + j, ld = ld_lo + j;
    const float vv = v[me];
    float inner = vv * t[me] + vv * (vv - v[ld]) / (2.f * std::sqrt(a[me] * b[me]));
    if (inner < 0.f) inner = 0.f;
    const float desired = s0[me] + inner;
    const float gap = x[ld] - x[me] - l[ld];
    const float ratio = vv / v0[me];
    const float free_flow = (ratio * ratio) * (ratio * ratio);
    const float q = desired / (gap + kEps);
    const float dv = a[me] * (1.f - free_flow - q * q);
    const float dvr = dv * s.rate;
    n_decel += dvr < 0.f;
    const float dx = s.rate * vv + 0.5f * dvr * s.rate;
    nx[j] = x[me] + (dx > 0.f ? dx : 0.f);
    const float vn = vv + dvr;
    nv[j] = vn > 0.f ? vn : 0.f;
  }
  for (int j = 0; j < count; ++j) {
    x[me_lo + j] = nx[j];
    v[me_lo + j] = nv[j];
  }
  return n_decel;
}

bool add_car(Sim& s, int road, const float* car_in) {
  const int pos = ring_next(s.lastcar[road]);
  float start_pos = kInf;
  if (s.lastcar[road] != s.leading[road]) {
    const int tail = s.lastcar[road];
    start_pos = s.car(road, X)[tail] - s.car(road, L)[tail] - s.car(road, S0)[tail];
  }
  if (pos != s.leading[road]) {
    for (int p = 0; p < kParams; ++p) s.car(road, p)[pos] = car_in[p];
    float* x = s.car(road, X);
    if (start_pos < x[pos]) x[pos] = start_pos;
    s.lastcar[road] = pos;
    return false;
  }
  if (s.dest[road] >= 0) s.rewards[s.dest[road]] -= kOverflowPenalty;
  return true;
}

void update_lights(Sim& s) {
  for (int e = 0; e < s.train_roads; ++e) {
    const int dst = s.dest[e];
    float* x = s.car(e, X);
    if (s.phase_group[e] == s.phase[dst] || s.elapsed[dst] < kYellowTicks) {
      x[s.leading[e]] = s.length;
    } else {
      const int nr = s.nxt[e];
      if (nr >= 0 && s.lastcar[nr] != s.leading[nr]) {
        x[s.leading[e]] = s.car(nr, X)[s.lastcar[nr]] + s.length;
      } else {
        x[s.leading[e]] = kInf;
      }
    }
  }
}

void move_cars(Sim& s) {
  update_lights(s);
  for (int e = 0; e < s.roads; ++e) {
    const int lead = s.leading[e], last = s.lastcar[e];
    if (lead == last) continue;
    const bool train = s.dest[e] >= 0;
    float* x = s.car(e, X);
    float* v = s.car(e, V);
    if (lead < last) {
      const int nd = idm_block(s, e, lead, lead + 1, last - lead);
      if (s.decel_penalty && train) {
        // latent DECEL_PENALTY shaping (traffic_env.py:196-198): one
        // f32 add of count/10 per road, ascending road order
        s.rewards[s.dest[e]] += (float)nd / 10.f;
      }
      if (train) {
        int wait = 0, det = 0;
        for (int j = lead + 1; j <= last; ++j) {
          wait += v[j] < kThresh;
          det += x[j] > s.length - kDetectRange;
        }
        s.waiting[e] += wait;
        s.detected[e] = det;
      }
    } else {
      // mirror slot -1 -> slot 0, then two contiguous segments
      for (int p = 0; p < kParams; ++p)
        s.car(e, p)[0] = s.car(e, p)[kCapacity - 1];
      const int nd1 = idm_block(s, e, lead, lead + 1, kCapacity - 1 - lead);
      const int nd2 = idm_block(s, e, 0, 1, last);
      if (s.decel_penalty && train) {
        // wrapped buffer: ONE add of the combined count
        // (traffic_env.py:204-205)
        s.rewards[s.dest[e]] += (float)(nd1 + nd2) / 10.f;
      }
      if (train) {
        int wait = 0, det = 0;
        for (int j = lead + 1; j < kCapacity; ++j) {
          wait += v[j] < kThresh;
          det += x[j] > s.length - kDetectRange;
        }
        // reference bug kept for parity: second segment tests POSITION
        // against the speed threshold (traffic_env.py:210)
        for (int j = 1; j <= last; ++j) {
          wait += x[j] < kThresh;
          det += x[j] > s.length - kDetectRange;
        }
        s.waiting[e] += wait;
        s.detected[e] = det;
      }
    }
  }
}

bool advance(Sim& s) {
  bool overflowed = false;
  float buf[kParams];
  for (int e = 0; e < s.roads; ++e) {
    while (s.leading[e] != s.lastcar[e] &&
           s.car(e, X)[ring_next(s.leading[e])] > s.length) {
      const int front = ring_next(s.leading[e]);
      const int nr = s.nxt[e];
      if (nr >= 0) {
        s.passed[e] += 1;
        s.passed_dst[s.dest[e]] = 1;
        s.rewards[s.dest[e]] += kPassingReward;
        s.car(e, X)[front] -= s.length;
        for (int p = 0; p < kParams; ++p) buf[p] = s.car(e, p)[front];
        overflowed = add_car(s, nr, buf) || overflowed;
      } else if (s.collect_trips) {
        s.trip_times.push_back((s.steps - s.car(e, W)[front]) / 2.f);
      }
      for (int p = 0; p < kParams; ++p)
        s.car(e, p)[front] = s.car(e, p)[s.leading[e]];
      s.leading[e] = front;
    }
  }
  return overflowed;
}

}  // namespace

extern "C" {

Sim* sim_create(int roads, int train_roads, int intersections, int m, int n,
                float length, const int32_t* dest, const int32_t* nxt,
                const int32_t* phase_group, float rate, int learn_switch,
                int collect_trips, int decel_penalty) {
  Sim* s = new Sim();
  s->roads = roads;
  s->train_roads = train_roads;
  s->intersections = intersections;
  s->m = m;
  s->n = n;
  s->length = length;
  s->rate = rate;
  s->learn_switch = learn_switch != 0;
  s->collect_trips = collect_trips != 0;
  s->decel_penalty = decel_penalty != 0;
  s->dest.assign(dest, dest + roads);
  s->nxt.assign(nxt, nxt + roads);
  s->phase_group.assign(phase_group, phase_group + roads);
  s->cars.assign((size_t)roads * kParams * kCapacity, 0.f);
  s->leading.assign(roads, 1);
  s->lastcar.assign(roads, 1);
  s->phase.assign(intersections, 0);
  s->elapsed.assign(intersections, 0);
  s->passed.assign(train_roads, 0);
  s->detected.assign(train_roads, 0);
  s->waiting.assign(train_roads, 0);
  s->passed_dst.assign(intersections, 0);
  s->rewards.assign(intersections, 0.f);
  return s;
}

void sim_destroy(Sim* s) { delete s; }

void sim_reset(Sim* s, const int32_t* phase) {
  s->steps = 0.f;
  s->generated = 0;
  for (int e = 0; e < s->roads; ++e) {
    for (int p = 0; p < kParams; ++p) s->car(e, p)[1] = 0.f;
    s->car(e, X)[1] = kInf;
  }
  std::fill(s->elapsed.begin(), s->elapsed.end(), 0);
  std::fill(s->passed.begin(), s->passed.end(), 0);
  std::fill(s->leading.begin(), s->leading.end(), 1);
  std::fill(s->lastcar.begin(), s->lastcar.end(), 1);
  std::fill(s->passed_dst.begin(), s->passed_dst.end(), 0);
  std::fill(s->waiting.begin(), s->waiting.end(), 0);
  std::memcpy(s->phase.data(), phase, s->intersections * sizeof(int32_t));
  // detected deliberately NOT cleared (traffic_env.py:259-272)
}

// One tick.  spawn_roads: entry road per arriving car this tick.
// Returns 1 if the episode overflowed.
int sim_step(Sim* s, const int32_t* action, const int32_t* spawn_roads,
             int n_spawn, int32_t* obs_out, float* rewards_out) {
  for (int i = 0; i < s->intersections; ++i) {
    int change;
    if (s->learn_switch) {
      change = action[i];
      s->phase[i] = (s->phase[i] != 0) ^ (action[i] != 0);
    } else {
      change = (s->phase[i] != 0) ^ (action[i] != 0);
      s->phase[i] = action[i];
    }
    s->elapsed[i] = change ? 0 : s->elapsed[i] + 1;
  }
  std::fill(s->rewards.begin(), s->rewards.end(), 0.f);
  std::fill(s->passed.begin(), s->passed.end(), 0);
  bool overflowed = false;
  float car_buf[kParams];
  for (int j = 0; j < n_spawn; ++j) {
    std::memcpy(car_buf, kArchetype, sizeof(car_buf));
    car_buf[W] = s->steps;
    s->generated += 1;
    overflowed = add_car(*s, spawn_roads[j], car_buf) || overflowed;
  }
  move_cars(*s);
  overflowed = advance(*s) || overflowed;
  s->steps += 1.f;

  int32_t* o = obs_out;
  std::memcpy(o, s->passed.data(), s->train_roads * sizeof(int32_t));
  o += s->train_roads;
  std::memcpy(o, s->detected.data(), s->train_roads * sizeof(int32_t));
  o += s->train_roads;
  std::memcpy(o, s->phase.data(), s->intersections * sizeof(int32_t));
  o += s->intersections;
  std::memcpy(o, s->elapsed.data(), s->intersections * sizeof(int32_t));
  std::memcpy(rewards_out, s->rewards.data(),
              s->intersections * sizeof(float));
  return overflowed ? 1 : 0;
}

// remi reward kernel (traffic_env.py:64-78); writes rewards_out and
// clears waiting / passed_dst.
void sim_remi(Sim* s, float* rewards_out) {
  std::fill(s->rewards.begin(), s->rewards.end(), 0.f);
  for (int e = 0; e < s->train_roads; ++e) {
    const int dst = s->dest[e];
    const bool green = s->phase_group[e] != s->phase[dst];
    if (s->waiting[e] > 0 && !green && !s->passed_dst[dst]) {
      s->rewards[dst] -= 0.5f;
    } else if (s->passed_dst[dst] && green && !(s->waiting[e] > 0)) {
      s->rewards[dst] += 0.5f;
    }
  }
  std::fill(s->passed_dst.begin(), s->passed_dst.end(), 0);
  std::fill(s->waiting.begin(), s->waiting.end(), 0);
  std::memcpy(rewards_out, s->rewards.data(),
              s->intersections * sizeof(float));
}

// Batched benchmark loop: T ticks entirely inside C++ against
// pre-generated per-tick actions and spawn lists, with the Repeater's
// remi call every `remi_every` ticks and auto-reset on overflow — the
// whole benchmark loop without any host-language round trips, so the
// measured rate is the sequential native core itself (the speed an
// optimally-compiled single-thread CPU implementation of the
// reference's numba kernels, traffic_env.py:46-218, can reach).
// actions: int32[T * intersections]; spawn_off: int32[T+1] prefix
// offsets into spawn_roads; reset_phases: int32[n_reset * I] cycled on
// each overflow reset.  Returns the number of resets taken, or -1 (and
// runs nothing) when n_reset < 1.
int64_t sim_run(Sim* s, const int32_t* actions, const int32_t* spawn_off,
                const int32_t* spawn_roads, int T, int remi_every,
                const int32_t* reset_phases, int n_reset) {
  // no phases to reset with: refuse before the first tick (the modulus
  // below would divide by zero on the first overflow)
  if (n_reset <= 0) return -1;
  std::vector<int32_t> obs(2 * s->train_roads + 2 * s->intersections);
  std::vector<float> rew(s->intersections);
  int64_t resets = 0;
  for (int t = 0; t < T; ++t) {
    const int done = sim_step(s, actions + (int64_t)t * s->intersections,
                              spawn_roads + spawn_off[t],
                              spawn_off[t + 1] - spawn_off[t],
                              obs.data(), rew.data());
    if (remi_every > 0 && (t + 1) % remi_every == 0)
      sim_remi(s, rew.data());
    if (done) {
      sim_reset(s, reset_phases +
                       (int64_t)(resets % n_reset) * s->intersections);
      ++resets;
    }
  }
  return resets;
}

void sim_cars_per_road(Sim* s, int32_t* out) {
  for (int e = 0; e < s->roads; ++e) {
    const int inv = s->leading[e] > s->lastcar[e];
    out[e] = inv * (kCapacity - 1) + s->lastcar[e] - s->leading[e];
  }
}

int sim_trip_count(Sim* s) { return (int)s->trip_times.size(); }
void sim_trips(Sim* s, float* out) {
  std::memcpy(out, s->trip_times.data(),
              s->trip_times.size() * sizeof(float));
}
int64_t sim_generated(Sim* s) { return s->generated; }

// raw state access for cross-validation
void sim_get_pointers(Sim* s, int32_t* leading, int32_t* lastcar) {
  std::memcpy(leading, s->leading.data(), s->roads * sizeof(int32_t));
  std::memcpy(lastcar, s->lastcar.data(), s->roads * sizeof(int32_t));
}
void sim_get_cars(Sim* s, float* out) {
  std::memcpy(out, s->cars.data(), s->cars.size() * sizeof(float));
}

}  // extern "C"
