// fixture launchers (KER001 reads the LFKT_API definitions)
#define LFKT_API extern "C" __attribute__((visibility("default")))

LFKT_API int lfkt_good(const void* x, void* y, int n, void* stream) { return 0; }
LFKT_API int lfkt_fallback(const void* x, void* y, int n, void* stream) { return 0; }
LFKT_API int lfkt_unchecked(const void* x, void* y, int n, void* stream) { return 0; }
LFKT_API int lfkt_guessing(const void* x, void* y, int n, void* stream) { return 0; }
LFKT_API int lfkt_unlisted(const void* x, void* y, int n, void* stream) { return 0; }
LFKT_API int lfkt_shared(const void* x, void* y, int n, void* stream) { return 0; }
LFKT_API int lfkt_query(int n) { return n; }
LFKT_API const char* lfkt_error_string(int status) { return ""; }
