// Set-up that belongs to a CUDA device, done once for each device a process
// launches on: a kernel's dynamic shared-memory limit (cudaFuncSetAttribute)
// holds only on the device that was current when it was set, so a process
// whose trackers or ranks run on several cards sets it on each.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

constexpr int kMaxDevices = 64;

// make(dev) -> T, called once for each device with that device current; ->
// the current device's T. T has an int `err`, which holds the CUDA error
// where the current device cannot be read.
template <typename T, typename Make>
const T& per_device(Make make) {
  static T values[kMaxDevices];
  static std::once_flag once[kMaxDevices];
  static T unreadable = [] {
    T t{};
    t.err = static_cast<int>(cudaErrorInvalidDevice);
    return t;
  }();
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return unreadable;
  std::call_once(once[dev], [&] { values[dev] = make(dev); });
  return values[dev];
}
