// Standalone profiling driver: reads the flat LP dump written by
// lp_gnn_tpu_torch.solver.native.dump_lp_bin
// (m,n,nnz int64; indptr int32[n+1]; indices int32[nnz];
// data f64[nnz]; c,lb,ub f64[n]; bl,bu f64[m]) and runs tpulp_solve so the
// solver can be profiled with gprof/perf outside the ctypes boundary.
#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <vector>

extern "C" int tpulp_solve(int m, int n, long long nnz,
                           const int* indptr, const int* indices,
                           const double* values, const double* c,
                           const double* lb, const double* ub,
                           const double* bl, const double* bu, int method,
                           int* col_basis, int* row_basis, int have_basis_in,
                           double* x_out, long long* info, double* dinfo,
                           long long max_iter);

int main(int argc, char** argv) {
  const char* path = argc > 1 ? argv[1] : "/tmp/lp_dump.bin";
  int reps = argc > 2 ? atoi(argv[2]) : 1;
  FILE* f = fopen(path, "rb");
  if (!f) { perror("open"); return 1; }
  int64_t hdr[3];
  if (fread(hdr, 8, 3, f) != 3) return 1;
  int m = (int)hdr[0], n = (int)hdr[1];
  long long nnz = hdr[2];
  std::vector<int> indptr(n + 1), indices(nnz);
  std::vector<double> data(nnz), c(n), lb(n), ub(n), bl(m), bu(m);
  if (fread(indptr.data(), 4, n + 1, f) != (size_t)(n + 1)) return 1;
  if (fread(indices.data(), 4, nnz, f) != (size_t)nnz) return 1;
  if (fread(data.data(), 8, nnz, f) != (size_t)nnz) return 1;
  if (fread(c.data(), 8, n, f) != (size_t)n) return 1;
  if (fread(lb.data(), 8, n, f) != (size_t)n) return 1;
  if (fread(ub.data(), 8, n, f) != (size_t)n) return 1;
  if (fread(bl.data(), 8, m, f) != (size_t)m) return 1;
  if (fread(bu.data(), 8, m, f) != (size_t)m) return 1;
  fclose(f);
  for (int r = 0; r < reps; ++r) {
    std::vector<int> colb(n), rowb(m);
    std::vector<double> x(n);
    long long info[2];
    double dinfo[2];
    int rc = tpulp_solve(m, n, nnz, indptr.data(), indices.data(),
                         data.data(), c.data(), lb.data(), ub.data(),
                         bl.data(), bu.data(), 1, colb.data(), rowb.data(), 0,
                         x.data(), info, dinfo, 0);
    printf("rc=%d niter=%lld obj=%.6f fact=%.3f\n", rc, info[0], dinfo[0],
           dinfo[1]);
  }
  return 0;
}
