// lmpc_runtime: native host-side runtime for the TPU LMPC engine.
//
// The reference stack's runtime outside the solver is C++ (ROS2 executors +
// DDS transport, CGAL KD-trees in trajectory_kd_tree.cpp, TBB-parallel
// safe-set queries in safe_set.cpp:185-191, Boost circular-buffer profiler in
// cycle_profiler.hpp, whitespace-table track/lap loaders in
// racing_trajectory.cpp:25-59).  This library provides the same roles for the
// TPU engine: the DEVICE compute path is JAX/XLA; everything host-side that
// sits on the control loop's critical path lives here behind a C ABI consumed
// via ctypes (racing_lmpc_tpu/native/__init__.py).
//
// Components:
//   1. whitespace numeric table loader (tracks, recorded safe-set laps)
//   2. static 2-D KD-tree (nearest / k-nearest), CGAL replacement
//   3. SafeSetStore: padded lap ring buffer + cost-to-go + multi-threaded
//      per-lap k-NN query with per-lap caps (TBB par_unseq replacement)
//   4. CycleProfiler: windowed min/mean/max timing statistics
//   5. Bus: intra-process topic pub/sub with a serialized dispatch thread
//      (single-spinner executor), the DDS/rclcpp replacement for wiring a
//      simulator process model to the controller without ROS.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread  (see native/__init__.py)

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <limits>
#include <map>
#include <mutex>
#include <numeric>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#define LR_API extern "C" __attribute__((visibility("default")))

// ---------------------------------------------------------------------------
// 1. table loader
// ---------------------------------------------------------------------------

// Parses a whitespace-separated numeric table (the 17-column trajectory files
// and the ss_lap_*_{x,u,k,t}.txt checkpoints; racing_trajectory.cpp:25-36).
// Rows with inconsistent column counts -> error (-1).  Returns the number of
// rows, writes column count; caller provides a buffer or asks for size first.
struct LrTable {
  std::vector<double> data;
  int64_t rows = 0, cols = 0;
};

LR_API void* lr_table_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(size), '\0');
  if (size > 0 && std::fread(&buf[0], 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  auto t = new LrTable();
  const char* p = buf.c_str();
  const char* end = p + buf.size();
  int64_t cols = -1;
  std::vector<double> row;
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!line_end) line_end = end;
    row.clear();
    const char* q = p;
    while (q < line_end) {
      while (q < line_end && std::isspace(static_cast<unsigned char>(*q))) ++q;
      if (q >= line_end || *q == '#') break;
      char* num_end = nullptr;
      double v = std::strtod(q, &num_end);
      if (num_end == q) break;  // unparsable token
      row.push_back(v);
      q = num_end;
    }
    if (!row.empty()) {
      if (cols < 0) cols = static_cast<int64_t>(row.size());
      if (static_cast<int64_t>(row.size()) != cols) {
        delete t;
        return nullptr;
      }
      t->data.insert(t->data.end(), row.begin(), row.end());
      ++t->rows;
    }
    p = line_end + 1;
  }
  t->cols = cols < 0 ? 0 : cols;
  return t;
}

LR_API int64_t lr_table_rows(void* h) { return static_cast<LrTable*>(h)->rows; }
LR_API int64_t lr_table_cols(void* h) { return static_cast<LrTable*>(h)->cols; }
LR_API void lr_table_copy(void* h, double* out) {
  auto* t = static_cast<LrTable*>(h);
  std::memcpy(out, t->data.data(), t->data.size() * sizeof(double));
}
LR_API void lr_table_free(void* h) { delete static_cast<LrTable*>(h); }

// ---------------------------------------------------------------------------
// 2. static 2-D KD-tree (replaces CGAL Orthogonal_k_neighbor_search,
//    trajectory_kd_tree.hpp:69-121)
// ---------------------------------------------------------------------------

struct KdNode {
  float split;
  int32_t axis;      // -1 for leaf
  int32_t left, right;
  int32_t begin, end;  // leaf range into order[]
};

struct KdTree {
  std::vector<float> px, py;     // points by original index
  std::vector<int32_t> order;    // permutation, leaves own ranges of it
  std::vector<KdNode> nodes;
  static constexpr int kLeaf = 16;

  int32_t build(int32_t begin, int32_t end) {
    KdNode nd{};
    nd.begin = begin;
    nd.end = end;
    if (end - begin <= kLeaf) {
      nd.axis = -1;
      nodes.push_back(nd);
      return static_cast<int32_t>(nodes.size()) - 1;
    }
    float xmin = std::numeric_limits<float>::max(), xmax = -xmin;
    float ymin = xmin, ymax = -xmin;
    for (int32_t i = begin; i < end; ++i) {
      int32_t j = order[i];
      xmin = std::min(xmin, px[j]); xmax = std::max(xmax, px[j]);
      ymin = std::min(ymin, py[j]); ymax = std::max(ymax, py[j]);
    }
    nd.axis = (xmax - xmin) >= (ymax - ymin) ? 0 : 1;
    int32_t mid = (begin + end) / 2;
    auto& coords = nd.axis == 0 ? px : py;
    std::nth_element(order.begin() + begin, order.begin() + mid,
                     order.begin() + end,
                     [&](int32_t a, int32_t b) { return coords[a] < coords[b]; });
    nd.split = coords[order[mid]];
    int32_t self = static_cast<int32_t>(nodes.size());
    nodes.push_back(nd);
    int32_t l = build(begin, mid);
    int32_t r = build(mid, end);
    nodes[self].left = l;
    nodes[self].right = r;
    return self;
  }

  // k-NN with a bounded max-heap.
  void knn(float qx, float qy, int k,
           std::vector<std::pair<float, int32_t>>& heap) const {
    heap.clear();
    knn_rec(0, qx, qy, k, heap);
    std::sort_heap(heap.begin(), heap.end());
  }

  void knn_rec(int32_t ni, float qx, float qy, size_t k,
               std::vector<std::pair<float, int32_t>>& heap) const {
    const KdNode& nd = nodes[ni];
    if (nd.axis < 0) {
      for (int32_t i = nd.begin; i < nd.end; ++i) {
        int32_t j = order[i];
        float dx = px[j] - qx, dy = py[j] - qy;
        float d2 = dx * dx + dy * dy;
        if (heap.size() < k) {
          heap.emplace_back(d2, j);
          std::push_heap(heap.begin(), heap.end());
        } else if (d2 < heap.front().first) {
          std::pop_heap(heap.begin(), heap.end());
          heap.back() = {d2, j};
          std::push_heap(heap.begin(), heap.end());
        }
      }
      return;
    }
    float qc = nd.axis == 0 ? qx : qy;
    int32_t near = qc < nd.split ? nd.left : nd.right;
    int32_t far = qc < nd.split ? nd.right : nd.left;
    knn_rec(near, qx, qy, k, heap);
    float gap = qc - nd.split;
    if (heap.size() < k || gap * gap < heap.front().first)
      knn_rec(far, qx, qy, k, heap);
  }
};

LR_API void* lr_kdtree_build(const float* xy, int64_t n) {
  auto* t = new KdTree();
  t->px.resize(static_cast<size_t>(n));
  t->py.resize(static_cast<size_t>(n));
  t->order.resize(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    t->px[static_cast<size_t>(i)] = xy[2 * i];
    t->py[static_cast<size_t>(i)] = xy[2 * i + 1];
    t->order[static_cast<size_t>(i)] = static_cast<int32_t>(i);
  }
  if (n > 0) t->build(0, static_cast<int32_t>(n));
  return t;
}

LR_API void lr_kdtree_knn(void* h, const float* q_xy, int64_t nq, int32_t k,
                          int32_t* out_idx, float* out_d2) {
  auto* t = static_cast<KdTree*>(h);
  std::vector<std::pair<float, int32_t>> heap;
  heap.reserve(static_cast<size_t>(k));
  for (int64_t qi = 0; qi < nq; ++qi) {
    t->knn(q_xy[2 * qi], q_xy[2 * qi + 1], k, heap);
    for (int32_t j = 0; j < k; ++j) {
      if (j < static_cast<int32_t>(heap.size())) {
        out_idx[qi * k + j] = heap[static_cast<size_t>(j)].second;
        out_d2[qi * k + j] = heap[static_cast<size_t>(j)].first;
      } else {
        out_idx[qi * k + j] = -1;
        out_d2[qi * k + j] = std::numeric_limits<float>::infinity();
      }
    }
  }
}

LR_API void lr_kdtree_free(void* h) { delete static_cast<KdTree*>(h); }

// ---------------------------------------------------------------------------
// 3. SafeSetStore (safe_set.cpp:33-191 equivalent)
// ---------------------------------------------------------------------------

struct Lap {
  // tripled (s - L, s, s + L) states and matching cost-to-go, exactly the
  // process_lap_data layout (safe_set.cpp:116-137)
  std::vector<float> x_rep;  // (3T, nx)
  std::vector<float> J_rep;  // (3T,)
  int64_t T = 0;
};

struct SafeSetStore {
  int64_t max_laps, nx;
  std::deque<Lap> laps;  // newest first
  mutable std::mutex mu;
  int n_threads;

  SafeSetStore(int64_t ml, int64_t nx_) : max_laps(ml), nx(nx_) {
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  }
};

LR_API void* lr_ss_new(int64_t max_laps, int64_t nx) {
  return new SafeSetStore(max_laps, nx);
}
LR_API void lr_ss_free(void* h) { delete static_cast<SafeSetStore*>(h); }

LR_API void lr_ss_add_lap(void* h, const float* x, int64_t T,
                          double total_length) {
  auto* s = static_cast<SafeSetStore*>(h);
  const int64_t nx = s->nx;
  Lap lap;
  lap.T = T;
  lap.x_rep.resize(static_cast<size_t>(3 * T * nx));
  lap.J_rep.resize(static_cast<size_t>(3 * T));
  for (int rep = 0; rep < 3; ++rep) {
    const float ds = static_cast<float>((rep - 1) * total_length);
    const float dJ = static_cast<float>((1 - rep) * (T - 1));
    for (int64_t i = 0; i < T; ++i) {
      float* dst = &lap.x_rep[static_cast<size_t>((rep * T + i) * nx)];
      std::memcpy(dst, x + i * nx, static_cast<size_t>(nx) * sizeof(float));
      dst[0] += ds;  // abscissa offset on state 0 (px/s)
      // J = [T-1 .. 0] with periodic offsets (J + T-1, J, J - T + 1)
      lap.J_rep[static_cast<size_t>(rep * T + i)] =
          static_cast<float>(T - 1 - i) + dJ;
    }
  }
  std::lock_guard<std::mutex> g(s->mu);
  s->laps.push_front(std::move(lap));
  while (static_cast<int64_t>(s->laps.size()) > s->max_laps) s->laps.pop_back();
}

LR_API int64_t lr_ss_num_laps(void* h) {
  auto* s = static_cast<SafeSetStore*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return static_cast<int64_t>(s->laps.size());
}

// Per-lap k nearest in the (s, t) plane, newest lap first, concatenated and
// truncated to max_total (SafeSetManager::query, safe_set.cpp:153-180).  The
// per-lap scans run on a thread pool — the role TBB par_unseq plays in the
// reference (safe_set.cpp:185-191).  Returns the number of rows written.
LR_API int64_t lr_ss_query(void* h, const float* q_xy, int32_t max_total,
                           int32_t max_per_lap, float* out_x, float* out_J) {
  auto* s = static_cast<SafeSetStore*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  const int64_t nx = s->nx;
  const size_t L = s->laps.size();
  if (L == 0 || max_total <= 0 || max_per_lap <= 0) return 0;

  std::vector<std::vector<std::pair<float, int64_t>>> found(L);
  auto work = [&](size_t li) {
    const Lap& lap = s->laps[li];
    const int64_t n = 3 * lap.T;
    auto& heap = found[li];
    const size_t k = static_cast<size_t>(std::min<int64_t>(max_per_lap, n));
    heap.reserve(k + 1);
    for (int64_t i = 0; i < n; ++i) {
      const float* p = &lap.x_rep[static_cast<size_t>(i * nx)];
      float dx = p[0] - q_xy[0], dy = p[1] - q_xy[1];
      float d2 = dx * dx + dy * dy;
      if (heap.size() < k) {
        heap.emplace_back(d2, i);
        std::push_heap(heap.begin(), heap.end());
      } else if (d2 < heap.front().first) {
        std::pop_heap(heap.begin(), heap.end());
        heap.back() = {d2, i};
        std::push_heap(heap.begin(), heap.end());
      }
    }
    std::sort_heap(heap.begin(), heap.end());
  };
  if (L > 1 && s->n_threads > 1) {
    std::vector<std::thread> pool;
    pool.reserve(L);
    for (size_t li = 0; li < L; ++li) pool.emplace_back(work, li);
    for (auto& th : pool) th.join();
  } else {
    for (size_t li = 0; li < L; ++li) work(li);
  }

  int64_t written = 0;
  for (size_t li = 0; li < L && written < max_total; ++li) {
    const Lap& lap = s->laps[li];
    for (auto& [d2, i] : found[li]) {
      if (written >= max_total) break;
      std::memcpy(out_x + written * nx,
                  &lap.x_rep[static_cast<size_t>(i * nx)],
                  static_cast<size_t>(nx) * sizeof(float));
      out_J[written] = lap.J_rep[static_cast<size_t>(i)];
      ++written;
    }
  }
  return written;
}

// ---------------------------------------------------------------------------
// 4. CycleProfiler (cycle_profiler.hpp:69-136 equivalent)
// ---------------------------------------------------------------------------

struct Profiler {
  std::vector<double> buf;
  size_t cap, head = 0, count = 0;
  std::mutex mu;
  explicit Profiler(size_t c) : buf(c), cap(c) {}
};

LR_API void* lr_prof_new(int64_t capacity) {
  return new Profiler(static_cast<size_t>(std::max<int64_t>(1, capacity)));
}
LR_API void lr_prof_free(void* h) { delete static_cast<Profiler*>(h); }
LR_API void lr_prof_add(void* h, double v) {
  auto* p = static_cast<Profiler*>(h);
  std::lock_guard<std::mutex> g(p->mu);
  p->buf[p->head] = v;
  p->head = (p->head + 1) % p->cap;
  p->count = std::min(p->count + 1, p->cap);
}
// out = {min, mean, max, count}
LR_API void lr_prof_stats(void* h, double* out) {
  auto* p = static_cast<Profiler*>(h);
  std::lock_guard<std::mutex> g(p->mu);
  if (p->count == 0) {
    out[0] = out[1] = out[2] = 0.0;
    out[3] = 0.0;
    return;
  }
  double mn = std::numeric_limits<double>::max(), mx = -mn, sum = 0;
  for (size_t i = 0; i < p->count; ++i) {
    double v = p->buf[i];
    mn = std::min(mn, v);
    mx = std::max(mx, v);
    sum += v;
  }
  out[0] = mn;
  out[1] = sum / static_cast<double>(p->count);
  out[2] = mx;
  out[3] = static_cast<double>(p->count);
}

// ---------------------------------------------------------------------------
// 5. Bus: intra-process pub/sub with one dispatch thread (the "executor").
//    Messages are opaque byte blobs; subscribers are C callbacks (ctypes
//    trampolines on the Python side).  Delivery is serialized in publish
//    order — the single-spinner rclcpp executor model the reference nodes
//    use for their mutually-exclusive callback groups
//    (racing_mpc_node.cpp:92-108).
// ---------------------------------------------------------------------------

using BusCallback = void (*)(const char* topic, const uint8_t* data,
                             int64_t len, void* user);

struct BusMsg {
  std::string topic;
  std::vector<uint8_t> data;
};

struct Bus {
  std::map<std::string, std::vector<std::pair<BusCallback, void*>>> subs;
  std::queue<BusMsg> q;
  std::mutex mu;
  std::condition_variable cv;
  std::thread worker;
  std::atomic<bool> stop{false};
  std::atomic<bool> busy{false};
  std::atomic<int64_t> delivered{0};

  Bus() {
    worker = std::thread([this] {
      std::unique_lock<std::mutex> lk(mu);
      while (true) {
        cv.wait(lk, [this] { return stop.load() || !q.empty(); });
        if (stop.load() && q.empty()) return;
        BusMsg msg = std::move(q.front());
        q.pop();
        busy.store(true);
        auto it = subs.find(msg.topic);
        std::vector<std::pair<BusCallback, void*>> cbs;
        if (it != subs.end()) cbs = it->second;
        lk.unlock();
        for (auto& [cb, user] : cbs)
          cb(msg.topic.c_str(), msg.data.data(),
             static_cast<int64_t>(msg.data.size()), user);
        delivered.fetch_add(1);
        busy.store(false);
        lk.lock();
      }
    });
  }
  ~Bus() {
    stop.store(true);
    cv.notify_all();
    if (worker.joinable()) worker.join();
  }
};

LR_API void* lr_bus_new() { return new Bus(); }
LR_API void lr_bus_free(void* h) { delete static_cast<Bus*>(h); }

LR_API void lr_bus_subscribe(void* h, const char* topic, BusCallback cb,
                             void* user) {
  auto* b = static_cast<Bus*>(h);
  std::lock_guard<std::mutex> g(b->mu);
  b->subs[topic].emplace_back(cb, user);
}

LR_API void lr_bus_publish(void* h, const char* topic, const uint8_t* data,
                           int64_t len) {
  auto* b = static_cast<Bus*>(h);
  {
    std::lock_guard<std::mutex> g(b->mu);
    BusMsg m;
    m.topic = topic;
    m.data.assign(data, data + len);
    b->q.push(std::move(m));
  }
  b->cv.notify_one();
}

// Block until all messages published so far are delivered (step-mode sync).
LR_API void lr_bus_flush(void* h, double timeout_s) {
  auto* b = static_cast<Bus*>(h);
  auto deadline =
      std::chrono::steady_clock::now() +
      std::chrono::duration_cast<std::chrono::steady_clock::duration>(
          std::chrono::duration<double>(timeout_s));
  while (std::chrono::steady_clock::now() < deadline) {
    {
      std::lock_guard<std::mutex> g(b->mu);
      if (b->q.empty() && !b->busy.load()) return;
    }
    std::this_thread::sleep_for(std::chrono::microseconds(50));
  }
}

LR_API int64_t lr_bus_delivered(void* h) {
  return static_cast<Bus*>(h)->delivered.load();
}
