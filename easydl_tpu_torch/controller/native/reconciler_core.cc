// Controller reconcile core — the native diff engine behind the operator.
//
// The reference's elastic-operator is a Go controller (SURVEY.md §2.1 item 1;
// .pre-commit-config.yaml:42-49) that "reconcile[s] Pods of the job against"
// a JobResource (docs/design/elastic-training-operator.md:97-98) and, for
// resource_updation entries, "launch[es] a new Pod ... to replace the Pod
// with the resource_updation.name" (:99-101). This C++ core implements that
// decision function: (desired plan, observed pods) -> pod operations. It is
// pure and level-triggered — the Python operator loop feeds it fresh state
// every pass and applies the returned ops, so a crash loses nothing.
//
// Wire format (line-based, '|'-separated — keeps the C ABI to two functions):
//   desired:  J|<job>            job name (pod-name prefix)
//             R|<role>|<replicas>|<resource_sig>
//             U|<pod_name>|<resource_sig>        resource_updation entry
//   observed: P|<name>|<role>|<phase>|<resource_sig>|<replaces>
//   ops out:  CREATE|<name>|<role>|<resource_sig>|<replaces>
//             DELETE|<name>|<reason>             reason: failed|replaced|scale_down
//
// Replace-then-retire: a replacement pod is CREATEd carrying `replaces`; the
// old pod is only DELETEd once its replacement reports Running. In-flight
// replacements don't count toward role replicas (the old pod still serves its
// slot), so scaling and replacement compose without double-counting.

#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <map>
#include <set>
#include <sstream>
#include <string>
#include <vector>

namespace {

struct Pod {
  std::string name, role, phase, sig, replaces;
  int index = -1;  // trailing -<n> of the name, -1 if unparsable
};

std::vector<std::string> split(const std::string& s, char sep) {
  std::vector<std::string> out;
  std::string cur;
  for (char c : s) {
    if (c == sep) {
      out.push_back(cur);
      cur.clear();
    } else {
      cur += c;
    }
  }
  out.push_back(cur);
  return out;
}

int trailing_index(const std::string& name) {
  size_t pos = name.rfind('-');
  if (pos == std::string::npos || pos + 1 >= name.size()) return -1;
  for (size_t i = pos + 1; i < name.size(); ++i) {
    if (!isdigit(name[i])) return -1;
  }
  return std::atoi(name.c_str() + pos + 1);
}

class Reconciler {
 public:
  std::string Run(const std::string& desired, const std::string& observed) {
    Parse(desired, observed);
    std::ostringstream ops;
    std::set<std::string> gone;  // pods DELETEd this pass

    // 1. Failed pods are retired; the scale rule below recreates the slot
    //    (reference: recover failed PS/workers, README.md:26-29).
    for (const auto& p : pods_) {
      if (p.phase == "Failed") {
        ops << "DELETE|" << p.name << "|failed\n";
        gone.insert(p.name);
      }
    }

    // Index live pods.
    std::map<std::string, const Pod*> by_name;
    std::map<std::string, const Pod*> replacement_of;  // old name -> new pod
    for (const auto& p : pods_) {
      if (gone.count(p.name)) continue;
      by_name[p.name] = &p;
    }
    for (const auto& p : pods_) {
      if (gone.count(p.name) || p.replaces.empty()) continue;
      if (by_name.count(p.replaces)) replacement_of[p.replaces] = &p;
    }

    // 2. resource_updation: replace-then-retire.
    for (const auto& u : updations_) {
      auto it = by_name.find(u.first);
      if (it == by_name.end()) continue;  // already retired
      const Pod* old = it->second;
      // Succeeded pods completed their work: resizing one is meaningless and
      // replacing it would re-run finished work (the completion loop).
      if (old->phase == "Terminating" || old->phase == "Succeeded") continue;
      auto rit = replacement_of.find(u.first);
      if (rit != replacement_of.end()) {
        if (rit->second->phase == "Running") {
          ops << "DELETE|" << old->name << "|replaced\n";
          gone.insert(old->name);
        }  // Pending replacement: wait.
      } else {
        std::string name = NextName(old->role);
        ops << "CREATE|" << name << "|" << old->role << "|" << u.second
            << "|" << old->name << "\n";
      }
    }

    // 3. Horizontal scaling per desired role. A role that has pods but is
    // absent from the plan means replicas 0 — omission must not orphan pods.
    // (The trainer role is operator-owned, never replica-levelled here.)
    for (const auto& p : pods_) {
      if (p.role != "trainer" && !roles_.count(p.role) &&
          !frozen_roles_.count(p.role)) {
        roles_[p.role] = {0, ""};
      }
    }
    for (const auto& r : roles_) {
      const std::string& role = r.first;
      int want = r.second.first;
      const std::string& sig = r.second.second;
      // Succeeded pods fill their slot permanently (k8s Job semantics): a
      // pod only exits 0 when its work is complete, so the slot is not
      // refilled and the pod is never scale_down'd. Identical in the
      // Python twin — pinned by the parity fuzzer.
      int done = 0;
      for (const auto& p : pods_) {
        if (p.role == role && !gone.count(p.name) && p.phase == "Succeeded") {
          ++done;
        }
      }
      int need = want - done;
      if (need < 0) need = 0;
      // Active = serving pods of the role: Pending/Running, not deleted this
      // pass, and not an in-flight replacement (its old pod holds the slot).
      // The exclusion requires the old pod to still be SERVING — once it is
      // Terminating/Failed, the replacement owns the slot (otherwise graceful
      // deletion would double-count the slot as empty and churn extra pods).
      std::vector<const Pod*> active;
      for (const auto& p : pods_) {
        if (p.role != role || gone.count(p.name)) continue;
        if (p.phase != "Pending" && p.phase != "Running") continue;
        if (!p.replaces.empty() && !gone.count(p.replaces)) {
          auto t = by_name.find(p.replaces);
          if (t != by_name.end() && (t->second->phase == "Pending" ||
                                     t->second->phase == "Running")) {
            continue;  // in-flight replacement
          }
        }
        active.push_back(&p);
      }
      int have = static_cast<int>(active.size());
      for (int i = have; i < need; ++i) {
        ops << "CREATE|" << NextName(role) << "|" << role << "|" << sig
            << "|\n";
      }
      if (have > need) {
        std::sort(active.begin(), active.end(),
                  [](const Pod* a, const Pod* b) { return a->index > b->index; });
        for (int i = 0; i < have - need; ++i) {
          ops << "DELETE|" << active[i]->name << "|scale_down\n";
          gone.insert(active[i]->name);
        }
      }
    }
    return ops.str();
  }

 private:
  void Parse(const std::string& desired, const std::string& observed) {
    for (const auto& line : split(desired, '\n')) {
      if (line.empty()) continue;
      auto f = split(line, '|');
      if (f[0] == "J" && f.size() >= 2) {
        job_ = f[1];
      } else if (f[0] == "R" && f.size() >= 4) {
        // Replicas must be all ASCII digits AND at most 7 of them (bounds
        // the value far below INT_MAX — atoi overflow is UB — and bounds
        // the levelling loop); a malformed count FREEZES the role for this
        // pass (no creates, no deletes) — merely skipping the line would
        // hand the role to the absent-role-means-replicas-0 fallback and
        // delete every healthy pod; atoi's silent 0 would do the same.
        // Identical in the Python twin — pinned by the fuzzer.
        bool valid = !f[2].empty() && f[2].size() <= 7;
        for (char c : f[2]) {
          if (c < '0' || c > '9') {
            valid = false;
            break;
          }
        }
        if (valid) {
          roles_[f[1]] = {std::atoi(f[2].c_str()), f[3]};
        } else {
          frozen_roles_.insert(f[1]);
        }
      } else if (f[0] == "U" && f.size() >= 3) {
        updations_.push_back({f[1], f[2]});
      }
    }
    for (const auto& line : split(observed, '\n')) {
      if (line.empty()) continue;
      auto f = split(line, '|');
      if (f[0] != "P" || f.size() < 6) continue;
      Pod p;
      p.name = f[1];
      p.role = f[2];
      p.phase = f[3];
      p.sig = f[4];
      p.replaces = f[5];
      p.index = trailing_index(p.name);
      int next = p.index + 1;
      if (next > next_index_[p.role]) next_index_[p.role] = next;
      pods_.push_back(std::move(p));
    }
  }

  // Fresh pod name: <job>-<role>-<n> with n past every observed index
  // (including Terminating/Failed pods, so names never collide).
  std::string NextName(const std::string& role) {
    int n = next_index_[role]++;
    return job_ + "-" + role + "-" + std::to_string(n);
  }

  std::string job_;
  std::set<std::string> frozen_roles_;  // malformed replicas: don't level
  std::map<std::string, std::pair<int, std::string>> roles_;
  std::vector<std::pair<std::string, std::string>> updations_;
  std::vector<Pod> pods_;
  std::map<std::string, int> next_index_;
};

}  // namespace

extern "C" {

// Returns a malloc'd ops string; caller frees with edr_free.
char* edr_reconcile(const char* desired, const char* observed) {
  Reconciler r;
  std::string out = r.Run(desired ? desired : "", observed ? observed : "");
  char* buf = static_cast<char*>(std::malloc(out.size() + 1));
  std::memcpy(buf, out.c_str(), out.size() + 1);
  return buf;
}

void edr_free(char* p) { std::free(p); }

}  // extern "C"
