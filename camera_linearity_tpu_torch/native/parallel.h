// parallel_items, shared by the native frame decoders and the TIFF codec
// (jpeg.cpp, tiff.cpp, png.cpp, huffyuv.cpp), each built as one
// translation unit.

#pragma once

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <thread>
#include <vector>

namespace {

// Run fn(i) for i in [0, n) on up to nthreads threads, each taking the
// next index from a shared counter (items differ in cost).
template <typename F>
void parallel_items(std::size_t n, int nthreads, F&& fn) {
    const int t = static_cast<int>(
        std::min<std::size_t>(n, static_cast<std::size_t>(std::max(1, nthreads))));
    if (t <= 1) {
        for (std::size_t i = 0; i < n; ++i) fn(i);
        return;
    }
    std::atomic<std::size_t> next{0};
    auto work = [&] {
        for (std::size_t i = next++; i < n; i = next++) fn(i);
    };
    std::vector<std::thread> threads;
    for (int k = 1; k < t; ++k) threads.emplace_back(work);
    work();
    for (auto& th : threads) th.join();
}

}  // namespace
