// NUMA discovery via sysfs only (no libnuma dependency): Linux hosts
// expose the standard /sys/devices/system/node layout
// (reference: csrc/storage/numa_utils.cpp:33-118, minus the CUDA query).

#include <pthread.h>
#include <sched.h>

#include <fstream>
#include <sstream>

#include "kvtpu_native.hpp"

namespace kvtpu {

std::vector<int> cpus_in_numa_node(int node) {
  std::vector<int> cpus;
  if (node < 0) return cpus;
  std::ostringstream path;
  path << "/sys/devices/system/node/node" << node << "/cpulist";
  std::ifstream in(path.str());
  if (!in) return cpus;
  std::string list;
  std::getline(in, list);
  // Format: comma-separated ranges, e.g. "0-3,8,10-11".
  std::stringstream ss(list);
  std::string part;
  while (std::getline(ss, part, ',')) {
    if (part.empty()) continue;
    const auto dash = part.find('-');
    try {
      if (dash == std::string::npos) {
        cpus.push_back(std::stoi(part));
      } else {
        const int lo = std::stoi(part.substr(0, dash));
        const int hi = std::stoi(part.substr(dash + 1));
        for (int cpu = lo; cpu <= hi; ++cpu) cpus.push_back(cpu);
      }
    } catch (const std::exception&) {
      return {};
    }
  }
  return cpus;
}

bool pin_thread_to_cpus(const std::vector<int>& cpus) {
  if (cpus.empty()) return false;
  cpu_set_t set;
  CPU_ZERO(&set);
  for (int cpu : cpus) CPU_SET(cpu, &set);
  return pthread_setaffinity_np(pthread_self(), sizeof(set), &set) == 0;
}

}  // namespace kvtpu
