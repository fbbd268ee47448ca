"""Experimental example engines (port of ``predictionio_tpu/examples``;
reference: examples/experimental/).

The reference ships 17 unsupported demo engines; each maps to a module here,
on the port's DASE controller SDK, with the JAX package's module names (an
engine.json naming ``predictionio_tpu.examples.X:factory`` resolves to
``predictionio_tpu_torch.examples.X:factory``):

================================  =======================================
reference directory               this package
================================  =======================================
scala-local-helloworld            helloworld
java-local-helloworld             helloworld (one runtime here)
java-parallel-helloworld          helloworld
java-local-tutorial               helloworld (tutorial variant of same)
scala-local-regression            regression
java-local-regression             regression
scala-parallel-regression         regression (k-fold eval + AverageServing)
scala-refactor-test               refactor_test
scala-local-friend-recommendation friend_recommendation (keyword + random)
scala-parallel-friend-recommend.  friend_recommendation (SimRank)
scala-parallel-similarproduct-    dimsum
  dimsum
scala-parallel-similarproduct-    dimsum (ALSSimilarModel; the baseline
  localmodel                        similarproduct template is the rest)
scala-parallel-recommendation-cat recommendation_variants (CategoryALS)
scala-parallel-recommendation-    recommendation_variants (EntityMapDS)
  entitymap
scala-parallel-recommendation-    recommendation_variants (SyntheticDS)
  custom-datasource
scala-parallel-recommendation-    recommendation_variants (any storage
  mongo-datasource                  scheme via PIO_STORAGE_* registry)
scala-cleanup-app                 apps (CleanupDataSource)
scala-parallel-trim-app           apps (TrimDataSource)
scala-local-movielens-filtering   movielens (TempFilterServing)
scala-local-movielens-evaluation  movielens (ItemRecEvaluation)
scala-stock                       stock (indicators, batched regression
                                    strategy, backtesting evaluator)
scala-recommendations             covered by models/recommendation
similarproduct/recommended-user   recommended_user (from the supported
  (examples/scala-parallel-...)     template family's variant set)
similarproduct/{filterbyyear,     similarproduct_variants (year filter,
  no-set-user, add-rateevent,       users-from-events, explicit rate
  add-and-return-item-properties}   signal, properties in results)
================================  =======================================
"""
